"""The port's two kernel modules against the JAX package, and (on a card)
each CUDA kernel against its plain PyTorch version.

K5 (``radardistill_tpu_torch/ops/expand.py``) is held bit-exact against the
Pallas ``expand_sorted_rows`` run in interpret mode, on monotone tables as
``tests/test_pallas_expand.py`` builds them (the TPU kernel's precondition),
and through ``densify_batch``. K2 (``ops/dcn.py`` + ``ops/dcn_sample.py``) is
held against ``modulated_deform_conv_mxu`` (interpret mode) where the shape
gate clamps offsets to ±5, and against the unclamped XLA formulation where it
does not, at the tolerance of ``tests/test_pallas_dcn.py`` (2e-5, float32
summation order). Inputs are made with numpy from fixed seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radardistill_tpu.ops import active_site as jasx
from radardistill_tpu.ops import pallas_dcn as jpdcn
from radardistill_tpu.ops import pallas_expand as jpe
from radardistill_tpu.ops.dcn import _modulated_deform_conv_xla
from radardistill_tpu_torch.ops import active_site as asx
from radardistill_tpu_torch.ops import dcn
from radardistill_tpu_torch.ops.dcn_sample import dcn_sample, dcn_sample_plain
from radardistill_tpu_torch.ops.expand import expand_rows, expand_rows_plain


def _monotone_inv(rng, m, r, occupancy):
    """Monotone active rows within each block (span < BLK), -1 elsewhere."""
    blk = jpe.BLK
    inv = np.full((m,), -1, np.int32)
    k = int(m * occupancy)
    if k:
        cells = np.sort(rng.choice(m, k, replace=False))
        inv[cells] = np.sort(rng.choice(r, k, replace=True))
        for b in range(m // blk):
            sl = inv[b * blk:(b + 1) * blk]
            act = sl >= 0
            if act.any():
                sl[act] = np.minimum(sl[act], sl[act].min() + blk - 1)
    return inv


# ---------------------------------------------------------------- K5 (CPU)


@pytest.mark.parametrize("occupancy", [0.0, 0.05, 0.8])
def test_expand_rows_matches_pallas(occupancy):
    rng = np.random.RandomState(0)
    m, r, c = 4 * jpe.BLK, 700, 32
    table = rng.randn(r, c).astype(np.float32)
    inv = _monotone_inv(rng, m, r, occupancy)
    want = np.asarray(jpe.expand_sorted_rows(jnp.asarray(table), jnp.asarray(inv), interpret=True))
    got = expand_rows(torch.from_numpy(table), torch.from_numpy(inv)).numpy()
    np.testing.assert_array_equal(got, want)


def test_expand_rows_out_of_table_rows_are_zero():
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3) - 20.0
    inv = torch.tensor([3, -1, 4, 0, 2**30, -(2**30)], dtype=torch.int32)
    got = expand_rows(table, inv)
    assert torch.equal(got[[0, 3]], table[[3, 0]])
    assert torch.equal(got[[1, 2, 4, 5]], torch.zeros(4, 3))
    assert not torch.signbit(got[[1, 2, 4, 5]]).any()  # +0, as the kernel writes


def test_expand_rows_cpu_takes_plain_version_without_counting():
    before = expand_rows.launches
    expand_rows(torch.zeros(2, 4), torch.zeros(3, dtype=torch.int32))
    assert expand_rows.launches == before


def test_densify_batch_matches_jax(monkeypatch):
    """The port's densify vs the JAX densify_batch with its Pallas kernel
    forced on (interpret mode)."""
    monkeypatch.setattr(jpe, "expand_rows", lambda table, inv: jpe.expand_sorted_rows(
        table, inv, interpret=True))
    rng = np.random.RandomState(3)
    h = w = 48
    b, c, cap = 2, 8, 64
    feats = rng.randn(b, cap, c).astype(np.float32)
    uids = np.full((b, cap), h * w, np.int32)
    for i in range(b):
        k = rng.randint(5, cap)
        uids[i, :k] = np.sort(rng.choice(h * w, k, replace=False))
    want_x, want_m = jasx.densify_batch(jnp.asarray(feats), jnp.asarray(uids), (h, w))
    got_x, got_m = asx.densify_batch(torch.from_numpy(feats), torch.from_numpy(uids), (h, w))
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


def test_site_index_grid_matches_jax():
    rng = np.random.RandomState(5)
    hw, cap = 300, 40
    uids = np.full((2, cap), hw, np.int32)
    uids[0, :25] = np.sort(rng.choice(hw, 25, replace=False))
    uids[1, :cap] = np.sort(rng.choice(hw, cap, replace=False))
    want = np.stack([np.asarray(jasx.site_index_grid(jnp.asarray(u), hw, cap)) for u in uids])
    got = asx.site_index_grid(torch.from_numpy(uids), hw, cap).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- K2 (CPU)


def _dcn_case(seed, h, w, c, co=32, off_scale=3.0, stride=2):
    rng = np.random.RandomState(seed)
    ho, wo = h // stride, w // stride
    x = rng.randn(1, h, w, c).astype(np.float32)
    offset = (off_scale * rng.randn(1, ho, wo, 18)).astype(np.float32)
    mask = (rng.rand(1, ho, wo, 9) * 0.9 + 0.05).astype(np.float32)
    weight = (rng.randn(3, 3, c, co) / np.sqrt(9 * c)).astype(np.float32)
    return x, offset, mask, weight


def _port_dcn(x, offset, mask, weight):
    return dcn.modulated_deform_conv(*map(torch.from_numpy, (x, offset, mask, weight)),
                                     stride=2, padding=1).numpy()


@pytest.mark.parametrize("window", ["inside", "across"])
def test_dcn_clamped_matches_pallas(window):
    """Gate-true shape (B1, 40x40, C=128): the port clamps to ±5 exactly as
    the Pallas kernels do, inside the window and across it."""
    x, offset, mask, weight = _dcn_case(0, 40, 40, 128, off_scale=3.0)
    if window == "inside":
        offset = np.clip(offset, -4.9, 4.9)
    else:
        assert (np.abs(offset) > 5).mean() > 0.05
    assert dcn.shapes_supported(x.shape, offset.shape, 2, 1, 3)
    want = np.asarray(jpdcn.modulated_deform_conv_mxu(
        *map(jnp.asarray, (x, offset, mask, weight)), 2, 1, 5, True))
    np.testing.assert_allclose(_port_dcn(x, offset, mask, weight), want, rtol=2e-5, atol=2e-5)


def test_dcn_unclamped_matches_xla():
    """Gate-false shape (H % 10 != 0): no clamp, as the JAX XLA path."""
    x, offset, mask, weight = _dcn_case(1, 24, 24, 64, off_scale=4.0)
    assert (np.abs(offset) > 5).mean() > 0.1
    assert not dcn.shapes_supported(x.shape, offset.shape, 2, 1, 3)
    want = np.asarray(_modulated_deform_conv_xla(
        *map(jnp.asarray, (x, offset, mask, weight)), stride=2, padding=1))
    np.testing.assert_allclose(_port_dcn(x, offset, mask, weight), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape,stride,pad,k", [
    ((1, 180, 180, 256), 2, 1, 3), ((1, 90, 90, 256), 2, 1, 3),
    ((1, 32, 32, 256), 2, 1, 3), ((1, 24, 24, 256), 2, 1, 3),
    ((1, 180, 180, 96), 2, 1, 3), ((1, 180, 180, 256), 1, 1, 3),
])
def test_shapes_supported_matches_jax(shape, stride, pad, k):
    off = (shape[0], shape[1] // stride, shape[2] // stride, 18)
    assert dcn.shapes_supported(shape, off, stride, pad, k) == jpdcn.shapes_supported(
        shape, off, stride, pad, k)


def test_dcn_zero_offset_unit_mask_is_a_conv():
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(1, 12, 14, 16).astype(np.float32))
    w = torch.from_numpy(rng.randn(3, 3, 16, 8).astype(np.float32))
    off = torch.zeros(1, 6, 7, 18)
    m = torch.ones(1, 6, 7, 9)
    got = dcn.modulated_deform_conv(x, off, m, w, stride=2, padding=1)
    want = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                                      stride=2, padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------- CUDA kernel legs (card only)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_cuda_expand_rows_matches_plain(cuda, dtype):
    rng = np.random.RandomState(7)
    table = torch.from_numpy((rng.randn(8193, 256) * 40).astype(np.float32)).to(cuda, dtype)
    inv = torch.from_numpy(rng.randint(-5, 8200, size=32400).astype(np.int32)).to(cuda)
    before = expand_rows.launches
    got = expand_rows(table, inv)
    torch.cuda.synchronize()
    assert expand_rows.launches == before + 1
    assert torch.equal(got, expand_rows_plain(table, inv))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("max_offset", [5.0, None])
@pytest.mark.parametrize("stride", [2, 1])
def test_cuda_dcn_sample_matches_plain(cuda, dtype, max_offset, stride):
    x, offset, mask, _ = _dcn_case(3, 40, 40, 128, off_scale=3.0, stride=stride)
    x = torch.from_numpy(x).to(cuda, dtype)
    offset, mask = torch.from_numpy(offset).to(cuda), torch.from_numpy(mask).to(cuda)
    got = dcn_sample(x, offset, mask, stride, 1, 3, max_offset)
    torch.cuda.synchronize()
    want = dcn_sample_plain(x, offset, mask, stride, 1, 3, max_offset)
    tol = 1e-5 if dtype == torch.float32 else 1e-2  # bf16: one rounding of the same f32 sum
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item()


@pytest.mark.gpu
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda):
    with pytest.raises(TypeError):
        expand_rows(torch.zeros(4, 8, device=cuda), torch.zeros(3, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        expand_rows(torch.zeros(8, 4, device=cuda).t(), torch.zeros(3, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):  # 24-byte rows: not whole 16-byte words
        expand_rows(torch.zeros(4, 6, device=cuda), torch.zeros(3, dtype=torch.int32, device=cuda))
    x = torch.zeros(1, 8, 8, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        dcn_sample(x, torch.zeros(1, 4, 4, 18, device=cuda), torch.zeros(1, 4, 4, 9, device=cuda))
    with pytest.raises(ValueError):  # the kernel samples 3x3 taps only
        dcn_sample(x.float(), torch.zeros(1, 4, 4, 50, device=cuda),
                   torch.zeros(1, 4, 4, 25, device=cuda), 2, 2, 5)
