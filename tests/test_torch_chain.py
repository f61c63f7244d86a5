"""The teacher's deep chains in the port against the JAX package, CPU: K6 (the
fused float link), K7 (the first-generation int8 link), the widened K1, and
the S2D backbone under ``INT8_STAGES`` 2-5, ``FP_STAGES`` 2-5 and ``INT8:
true``; and (on a card) each CUDA kernel against its plain version.

The same numpy inputs, made from a seed, go through the JAX function and its
counterpart in the port. The JAX side reaches its Pallas kernels in interpret
mode on its own, as ``tests/test_conv_block_v2.py`` and ``tests/test_int8.py``
run them; on the CPU the port takes its plain versions. The backbone runs at
grid 64, batch 2, on a seeded packed-order table with the host's occupancy
masks, from one set of JAX variables (BN statistics, scales and biases
overwritten by seeded values) bridged by ``convert.load_jax_variables``.

Tolerances.
  - K6 link: float32 within 1e-5 x max|ref| (summation order of a K = 9 x 128
    float32 sum), bfloat16 within 1e-2 x max|ref| (one bfloat16 rounding of a
    differently ordered float32 sum).
  - K7 link: its int8 codes against the JAX kernel's may differ by 1 on at
    most 1e-3 of the entries, for the reason ``tests/test_torch_conv_block.py``
    states (XLA's CPU backend may fuse a multiply-add the port rounds twice);
    against the port's own second-generation link they are bit-equal.
  - backbone: ``INT8_STAGES`` n: rel-L2 <= 1e-3 on ``x_conv2..5``, and the
    codes of the deepest int8 stage within 1, differing on at most 1e-3 of
    the entries (a flipped code moves one activation by bound / 254);
    ``FP_STAGES`` and ``INT8: true`` in float32: rel-L2 <= 1e-4 (the dynamic
    int8 path rounds ``x / sx`` to integers on both sides; a value within an
    ulp of a half may round apart, which moves one product by one step of the
    scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from radardistill_tpu.ops import pallas_conv_block as jcb
from radardistill_tpu.ops import pallas_int8_conv as jic
from radardistill_tpu_torch.convert import load_jax_variables
from radardistill_tpu_torch.data.synthetic import make_batch
from radardistill_tpu_torch.models import backbone_s2d as s2d
from radardistill_tpu_torch.models import layers
from radardistill_tpu_torch.ops import conv3x3_wgmma
from radardistill_tpu_torch.ops import conv_block as cb
from radardistill_tpu_torch.ops import int8_conv as ic
from radardistill_tpu_torch.utils.production import TRAIN_YAML
from tests.test_torch_conv_block import CODE_SHARE_LIMIT, _link

# Six xdist workers share the machine's cores: one intra-op thread per worker
# keeps torch's thread pools from oversubscribing them (the suite is bound by
# its total CPU time). The tolerances here hold for any thread count.
torch.set_num_threads(1)

GRID = 64
J_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _ids(case):
    return "-".join(f"{k}{v}" for k, v in case.items())


@pytest.fixture(scope="module")
def jlayers():
    """The JAX package's layers (flax): imported here and below, not at the
    top, so that the card-only legs collect on a machine without flax."""
    return pytest.importorskip("radardistill_tpu.models.layers")


@pytest.fixture(scope="module")
def jax_s2d():
    return pytest.importorskip("radardistill_tpu.models.backbone_s2d")


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


# ------------------------------------------------------------------ K6 link


def _fp_link(seed, kh, w, c, co, res, nph=1, b=2, h=8):
    rng = np.random.RandomState(seed)
    link = dict(
        x=rng.randn(b, h, w, c).astype(np.float32),
        k=rng.randn(kh, kh, c, co).astype(np.float32) * 0.1,
        gt=(rng.rand(co) + 0.5).astype(np.float32), sh=(rng.randn(co) * 0.1).astype(np.float32),
        bias=(rng.randn(co) * 0.1).astype(np.float32),
        mask=(rng.rand(b, h, w, nph) > 0.3).astype(np.int8),
        res=rng.randn(b, h, w, co).astype(np.float32) if res else None)
    return link


FP_CASES = [dict(kh=3, w=32, c=64, co=64, res=False), dict(kh=3, w=24, c=64, co=64, res=True),
            dict(kh=2, w=16, c=128, co=64, res=False), dict(kh=3, w=16, c=128, co=128, res=True),
            dict(kh=3, w=16, c=128, co=128, res=True, nph=4)]


def _run_fp_torch(link, dtype, device="cpu", block=cb.conv_block_fp):
    t = lambda a, dt=None: None if a is None else torch.as_tensor(a).to(device, dt)  # noqa: E731
    return cb.fp_block_conv(t(link["x"], dtype), t(link["k"]), t(link["bias"]), t(link["gt"]),
                            t(link["sh"]), t(link["mask"]), t(link["res"], dtype), block=block)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FP_CASES, ids=_ids)
def test_fp_link_matches_pallas(case, dtype, tol):
    link = _fp_link(2, **case)
    j = lambda a, dt=None: None if a is None else jnp.asarray(a, dt)  # noqa: E731
    want = jcb.fp_block_conv(j(link["x"], J_DTYPE[dtype]), j(link["k"]), j(link["bias"]),
                             j(link["gt"]), j(link["sh"]), j(link["mask"]),
                             res=j(link["res"], J_DTYPE[dtype]))
    want = np.asarray(want, np.float32)
    before = cb.conv_block_fp.launches
    got = _run_fp_torch(link, dtype)
    assert cb.conv_block_fp.launches == before  # a CPU tensor takes the plain version
    assert got.dtype == dtype and tuple(got.shape) == want.shape
    assert np.abs(got.float().numpy() - want).max() <= tol * np.abs(want).max()
    assert (want > 0).mean() > 0.1


def test_fp_link_rejects_what_it_does_not_take():
    link = _fp_link(3, **FP_CASES[0])
    t = torch.as_tensor
    x, k, mask, ab = t(link["x"]), t(link["k"]), t(link["mask"]), torch.zeros(2, 64)
    with pytest.raises(TypeError):
        cb.conv_block_fp(x, k.bfloat16(), ab, mask)  # the kernel must be in x's dtype
    with pytest.raises(ValueError):
        cb.conv_block_fp(x, k, ab[:, :32], mask)
    with pytest.raises(ValueError):
        cb.conv_block_fp(x, k, ab, mask, identity=True)  # the bare conv takes no epilogue


# ------------------------------------------------------------------ K7 link

CHAIN_CASES = [dict(kh=3, zero=0.0), dict(kh=3, zero=127.0), dict(kh=2, zero=127.0),
               dict(kh=3, zero=127.0, w=24, with_res=True),
               dict(kh=3, zero=127.0, nph=4, c=128, co=128, h=8, with_res=True),
               dict(kh=2, zero=0.0, c=128, co=64, w=24, with_res=True)]


def _lane_mask(link):
    return np.repeat(link["mask"], link["kq"].shape[-1] // link["mask"].shape[-1], axis=-1)


def _run_chain_torch(link, mask_q, device="cpu", block=ic.chain_conv):
    t = lambda a: torch.as_tensor(a).to(device)  # noqa: E731
    res = link["res"] and (t(link["res"][0]), t(link["res"][1]), link["res"][2])
    return ic.int8_block_conv(
        (t(link["xq"]), t(link["bnd"]), link["zero"]), t(link["kq"]), t(link["sw"]),
        t(link["bias"]), t(link["gt"]), t(link["sh"]), t(link["bound"]), t(mask_q), res=res,
        block=block)


@pytest.mark.parametrize("case", CHAIN_CASES, ids=_ids)
def test_chain_link_codes_match_pallas(case):
    link = _link(10, **case)
    mq = _lane_mask(link)
    j = jnp.asarray
    res = link["res"] and (j(link["res"][0]), j(link["res"][1]), link["res"][2])
    qj, bj, zj = jic.int8_block_conv(
        (j(link["xq"]), j(link["bnd"]), link["zero"]), j(link["kq"]), j(link["sw"]),
        j(link["bias"]), j(link["gt"]), j(link["sh"]), j(link["bound"]), j(mq), res=res)
    before = ic.chain_conv.launches
    qt, bt, zt = _run_chain_torch(link, mq)
    assert ic.chain_conv.launches == before
    qj = np.asarray(qj).astype(np.int32)
    diff = np.abs(qt.numpy().astype(np.int32) - qj)
    share = float((diff != 0).mean())
    print(f"share of differing codes: {share:.2e}")
    assert diff.max() <= 1 and share <= CODE_SHARE_LIMIT
    assert float(bt) == float(bj) and zt == zj == 127.0
    assert (qj > -127).mean() > 0.1


@pytest.mark.parametrize("case", CHAIN_CASES, ids=_ids)
def test_chain_link_equals_the_v2_link(case):
    """On operands both generations take, every code is equal (the JAX
    statement of it: ``tests/test_conv_block_v2.py::test_int8_v2_matches_v1``)."""
    from tests.test_torch_conv_block import _run_torch

    link = _link(11, **case)
    q1, b1, _ = _run_chain_torch(link, _lane_mask(link))
    q2, b2, _ = _run_torch(link)
    assert torch.equal(q1, q2) and float(b1) == float(b2)


def test_chain_link_reads_its_mask_per_channel():
    """A mask that differs from channel to channel (no compact form)."""
    link = _link(12, kh=3, zero=127.0, c=32, co=32)
    mq = (np.random.RandomState(13).rand(2, 16, 16, 32) > 0.5).astype(np.int8)
    q, _, _ = _run_chain_torch(link, mq)
    full, _, _ = _run_chain_torch(link, np.ones_like(mq))
    want = np.where(mq > 0, full.numpy(), -127)  # a masked cell holds the code of 0
    np.testing.assert_array_equal(q.numpy(), want)


def test_v1_switch_routes_the_dispatcher_through_the_chain_link(monkeypatch):
    from tests.test_torch_conv_block import _run_torch

    link = _link(14, kh=3, zero=127.0, nph=4, c=64, co=64, with_res=True)
    t = torch.as_tensor
    args = ((t(link["xq"]), t(link["bnd"]), link["zero"]), t(link["kq"]), t(link["sw"]),
            t(link["bias"]), t(link["gt"]), t(link["sh"]), t(link["bound"]), t(link["mask"]))
    res = (t(link["res"][0]), t(link["res"][1]), link["res"][2])
    calls = []
    real = ic.int8_block_conv
    monkeypatch.setattr(ic, "int8_block_conv",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    q2 = cb.int8_block(*args, res=res)
    assert not calls
    monkeypatch.setenv("CONV_BLOCK_V1", "1")
    q1 = cb.int8_block(*args, res=res)
    assert calls == [1] and torch.equal(q1[0], q2[0]) and q1[2] == 127.0
    # no float output in the first generation: requantize, then dequantize
    y1 = cb.int8_block(*args, res=res, deq_out=torch.float32)
    want = layers.deq8(q1[0], q1[1], 127.0)
    assert y1.dtype == torch.float32 and torch.equal(y1, want)
    y2 = _run_torch(link, deq_out=torch.float32)
    inside = y2 <= q1[1]  # beyond the bound the code saturates
    assert inside.float().mean() > 0.9
    assert (y1 - y2)[inside].abs().max() <= float(q1[1]) / 254.0


def test_chain_conv_rejects_what_it_does_not_take():
    link = _link(15, h=8, w=8)
    t = torch.as_tensor
    xp = F.pad(t(link["xq"]), (0, 0, 0, 0, 1, 1))
    mq, ab = t(_lane_mask(link)), torch.zeros(8, 32)
    with pytest.raises(ValueError):
        ic.chain_conv(t(link["xq"]), t(link["kq"]), ab, mq)  # not padded in H
    with pytest.raises(ValueError):
        ic.chain_conv(xp, t(link["kq"]), ab, t(link["mask"]))  # a compact mask
    with pytest.raises(TypeError):
        ic.chain_conv(xp.float(), t(link["kq"]), ab, mq)


# the link shapes (kh, C, Co) of the INT8_STAGES: 5 chain, which CONV_BLOCK_V1=1
# sends through K7: the stage-1 links, the deeper ones (chip_smoke.INT8_DEEP_LINKS)
# and the conv5 link K7 always takes
V1_LINKS = {(3, 128, 128): "wgmma", (2, 128, 64): "streamed", (3, 64, 64): "streamed",
            (2, 256, 128): "wgmma", (3, 128, 128): "wgmma", (2, 512, 256): "wgmma",
            (3, 256, 256): "wgmma", (2, 1024, 256): "wgmma"}


def test_chain_route_of_sends_the_128_channel_links_to_wgmma():
    """C and Co multiples of 128 go to the ``wgmma`` mainloop (the conv5
    link and every such link under ``CONV_BLOCK_V1=1``); the Co-64 and C-64
    links, and any other width, stay on the streamed kernel."""
    for (kh, c, co), route in V1_LINKS.items():
        assert ic.chain_route_of(kh, c, co) == route, (kh, c, co)
    for kh, c, co in ((3, 32, 32), (2, 128, 16), (3, 384, 192), (2, 96, 128)):
        assert ic.chain_route_of(kh, c, co) == "streamed"
    assert ic.chain_route_of(3, 384, 640) == "wgmma"
    with pytest.raises(ValueError):
        ic.chain_route_of(1, 128, 128)


@pytest.mark.parametrize("kh,w,with_res", [(2, 15, False), (3, 15, True), (3, 9, False)])
def test_interior_rows_with_the_border_correction_equal_the_padded_link(kh, w, with_res):
    """What the ``wgmma`` route computes, on the CPU: the interior rows of the
    padded input (a view, no copy) convolved with zeros outside, plus
    ``border_correction``, is the exact int32 accumulator of the input padded
    with ``zpad`` rows (-127: the carry's zero is 127), at odd W; the codes
    that K1's epilogue makes from it with the lane mask equal
    ``chain_conv_plain``'s, which match the Pallas kernel's (interpret mode)
    as ``test_chain_link_codes_match_pallas`` holds them."""
    link = _link(16, kh=kh, zero=127.0, c=32, co=32, h=10, w=w, with_res=with_res)
    mq = (np.random.RandomState(17).rand(2, 10, w, 32) > 0.4).astype(np.int8)
    t = torch.as_tensor
    xq, kq, zpad = t(link["xq"]), t(link["kq"]), -127
    xp = F.pad(xq, (0, 0, 0, 0, 1, kh - 2), value=zpad)
    x = conv3x3_wgmma.interior_rows(xp, kh)
    assert torch.equal(x, xq) and x.stride() == xp.stride()
    assert x.data_ptr() == xp.data_ptr() + w * 32  # row 1 of image 0
    pad = (1, kh - 2)
    acc = (cb.int_conv_exact(x, kq, 1, (pad, pad), 0)
           + cb.border_correction(cb.tap_sums(kq), 10, w, kh, zpad))
    assert torch.equal(acc, cb.int_conv_exact(xp, kq, 1, ((0, 0), pad), zpad))

    res = link["res"] and (t(link["res"][0]), t(link["res"][1]), link["res"][2])
    ab = cb.link_constants((xq, t(link["bnd"]), 127.0), kq, t(link["sw"]), t(link["bias"]),
                           t(link["gt"]), t(link["sh"]), t(link["bound"]), res)[0]
    r = None if res is None else res[0]
    q = ic.chain_conv_plain(xp, kq, ab, t(mq), r, zpad)
    assert torch.equal(cb.conv_block_plain(x, kq, ab, t(mq), r, zpad), q)
    j = jnp.asarray
    jres = link["res"] and (j(link["res"][0]), j(link["res"][1]), link["res"][2])
    qj = np.asarray(jic.int8_block_conv(
        (j(link["xq"]), j(link["bnd"]), 127.0), j(link["kq"]), j(link["sw"]), j(link["bias"]),
        j(link["gt"]), j(link["sh"]), j(link["bound"]), j(mq), res=jres)[0]).astype(np.int32)
    diff = np.abs(q.numpy().astype(np.int32) - qj)
    assert diff.max() <= 1 and float((diff != 0).mean()) <= CODE_SHARE_LIMIT
    assert (qj > -127).mean() > 0.1


# ------------------------------------------------------ helpers of the chains


def test_int_conv_exact_stays_exact_at_1024_channels():
    """The conv5 link contracts 1024 channels per tap: 1024 * 127**2 < 2**24,
    so each tap's float32 matmul is still exact; the taps add up in int32."""
    assert 1024 * 127 * 127 < 2 ** 24 < 4 * 1024 * 127 * 127
    xq = torch.full((1, 3, 3, 1024), 127, dtype=torch.int8)
    kq = torch.full((2, 2, 1024, 8), 127, dtype=torch.int8)
    kq[0, 0, 0, 0] = 126
    acc = cb.int_conv_exact(xq, kq, 1, ((1, 0), (1, 0)))
    assert acc.dtype == torch.int32
    assert int(acc[0, 1, 1, 0]) == 4 * 1024 * 127 * 127 - 127
    assert int(acc[0, 1, 1, 1]) == 4 * 1024 * 127 * 127 > 2 ** 24
    assert int(acc[0, 0, 0, 0]) == 1024 * 127 * 127  # three taps in the zero padding


@pytest.mark.parametrize("stride,padding", [(1, ((1, 1), (1, 1))), (2, ((1, 1), (1, 1))),
                                            (1, ((1, 0), (1, 0)))])
def test_dynamic_int8_conv_matches_jax(jlayers, stride, padding):
    rng = np.random.RandomState(16)
    kh = 2 if padding == ((1, 0), (1, 0)) else 3
    x = rng.randn(2, 12, 14, 32).astype(np.float32)
    k = rng.randn(kh, kh, 32, 24).astype(np.float32) * 0.1
    bias = rng.randn(24).astype(np.float32) * 0.1
    want = np.asarray(jlayers.int8_conv(jnp.asarray(x), jnp.asarray(k), stride, padding,
                                        jnp.asarray(bias)))
    got = layers.int8_conv(torch.from_numpy(x), torch.from_numpy(k), stride, padding,
                           torch.from_numpy(bias))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_conv2d_views_match_jax(jlayers):
    """``raw`` and ``qpieces`` of the port's conv against the flax module's."""
    rng = np.random.RandomState(17)
    k = rng.randn(3, 3, 16, 24).astype(np.float32) * 0.2
    bias = rng.randn(24).astype(np.float32)
    conv = layers.Conv2dTorch(16, 24, 3, 1, 1, use_bias=True)
    with torch.no_grad():
        conv.conv.weight.copy_(torch.from_numpy(k).permute(3, 2, 0, 1))
        conv.conv.bias.copy_(torch.from_numpy(bias))
    variables = {"params": {"conv": {"kernel": k, "bias": bias}}}
    jconv = jlayers.Conv2dTorch(24, 3, 1, 1, use_bias=True)
    kj, bj = jconv.apply(variables, jnp.zeros((1, 4, 4, 16)), raw=True)
    kq, sw, bq = jconv.apply(variables, jnp.zeros((1, 4, 4, 16)), qpieces=True)
    kt, bt = conv.raw()
    assert kt.is_contiguous()
    np.testing.assert_array_equal(kt.detach().numpy(), np.asarray(kj))
    np.testing.assert_array_equal(bt.detach().numpy(), np.asarray(bj))
    kqt, swt, bqt = conv.qpieces()
    np.testing.assert_array_equal(kqt.numpy(), np.asarray(kq))
    np.testing.assert_allclose(swt.detach().numpy(), np.asarray(sw), rtol=1e-6)
    np.testing.assert_array_equal(bqt.detach().numpy(), np.asarray(bq))


def test_wpair_kernel_matches_jax_and_equals_the_plain_conv(jax_s2d):
    rng = np.random.RandomState(18)
    k = rng.randn(3, 3, 16, 8).astype(np.float32)
    kp = s2d.wpair_kernel(torch.from_numpy(k))
    np.testing.assert_array_equal(kp.numpy(), np.asarray(jax_s2d.wpair_kernel(jnp.asarray(k))))
    # the conv on the W-paired layout is the plain conv (tests/test_wpair.py)
    x = torch.from_numpy(rng.randn(2, 6, 10, 16).astype(np.float32))
    conv = lambda a, w: F.conv2d(a.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),  # noqa: E731
                                 padding=1).permute(0, 2, 3, 1)
    want = conv(x, torch.from_numpy(k))
    got = conv(x.reshape(2, 6, 5, 32), kp).reshape(2, 6, 10, 8)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


# ---------------------------------------------------------------- the backbone

CONFIGS = {
    "int8-stages2": dict(int8_static=True, int8_stages=2),
    "int8-stages3": dict(int8_static=True, int8_stages=3),
    "int8-stages5": dict(int8_static=True, int8_stages=5),
    "fp-stages2": dict(fp_stages=2),
    "fp-stages5": dict(fp_stages=5),
    "int8-stages1-fp-stages5": dict(int8_static=True, int8_stages=1, fp_stages=5),
    "int8-stages3-fp-stages5": dict(int8_static=True, int8_stages=3, fp_stages=5),
    "int8-true": dict(int8=True),
}
KEYS = ("x_conv2", "x_conv3", "x_conv4", "x_conv5")


@pytest.fixture(scope="module")
def backbone_inputs(jax_s2d):
    """A seeded packed-order table on the host-built site list of two
    synthetic scenes, the host's occupancy masks, and one set of variables."""
    from tests.test_torch_slice import _perturb

    _, _, batch = make_batch(TRAIN_YAML, grid=GRID, num_lidar=1500, num_radar=100, num_boxes=5)
    uids = np.asarray(batch["hp_lidar"]["uids"])
    rng = np.random.RandomState(21)
    table = (rng.rand(*uids.shape, 32) * 2.0).astype(np.float32)
    table *= (uids < GRID * GRID)[..., None]
    masks = tuple(np.asarray(m) for m in batch["hp_masks"])
    jm = jax_s2d.PillarRes18BackBone8xS2D(table_input=True, hw=(GRID, GRID), packed_table=True)
    jmasks = tuple(jnp.asarray(m) for m in masks)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(table), jnp.asarray(uids), False, jmasks)
    variables = _perturb(jax.tree.map(np.asarray, dict(variables)), seed=22)
    return table, uids, masks, jmasks, variables


BLOCKS = ("conv2_down", "conv2_0", "conv2_1", "conv3_down", "conv3_0", "conv3_1",
          "conv4_down", "conv4_0", "conv4_1", "conv5_0", "conv5_1")


@pytest.fixture(scope="module", params=list(CONFIGS), ids=list(CONFIGS))
def backbone_run(request, backbone_inputs, jax_s2d):
    """Both backbones on the same inputs; of the port's, every block's input
    and output as well. The JAX side runs op by op, not under one ``jit``:
    fused, XLA's CPU backend contracts multiply-adds and turns the dynamic
    path's ``x / sx`` into another rounding, which flips quantization codes."""
    table, uids, masks, jmasks, variables = backbone_inputs
    kwargs = CONFIGS[request.param]
    jm = jax_s2d.PillarRes18BackBone8xS2D(table_input=True, hw=(GRID, GRID), packed_table=True,
                                          **kwargs)
    jout = jax.tree.map(np.asarray, jm.apply(variables, jnp.asarray(table), jnp.asarray(uids),
                                             False, jmasks))
    tm = load_jax_variables(s2d.PillarRes18BackBone8xS2D((GRID, GRID), **kwargs).eval(), variables)
    seen = {}
    for name in BLOCKS:
        getattr(tm, name).register_forward_hook(
            lambda mod, args, out, name=name: seen.__setitem__(name, (args, out)))
    with torch.no_grad():
        tout = tm(torch.from_numpy(table), torch.from_numpy(uids),
                  tuple(torch.from_numpy(m) for m in masks))
    return kwargs, tm, jout, tout, seen, variables


def _int8_depth(kwargs):
    return kwargs.get("int8_stages", 1) if kwargs.get("int8_static") else 0


@pytest.mark.parametrize("key", KEYS)
def test_chain_backbone_matches_jax(backbone_run, key):
    """The whole backbone. A float configuration agrees to 1e-4. Under an int8
    chain two correct runs drift apart: the JAX kernel's epilogue, compiled for
    the CPU, fuses ``acc * alpha + beta`` where the port rounds twice, which
    flips about 3e-5 of the stage-1 codes (those within an ulp of a half);
    each flipped code reaches 9 x Co outputs of the next link and flips a few
    percent of them, and from stage 2 on one code is a large step (the BN
    bound is ten times the activations these weights produce: the coarseness
    that made the reference reject int8 beyond stage 1). Measured here:
    rel-L2 1.3e-2 at depth 2, 0.14 at depth 5. So this test only bounds the
    drift (1e-3 at depth 1, 0.25 beyond); what holds the chain's blocks tightly
    is ``test_chain_block_matches_jax_on_the_same_input`` below."""
    kwargs, _, jout, tout, _, _ = backbone_run
    depth = _int8_depth(kwargs)
    tol = 1e-4 if depth == 0 else 1e-3 if depth == 1 else 0.25
    assert tout[key].dtype == torch.float32 and tuple(tout[key].shape) == jout[key].shape
    err = _rel_l2(tout[key].numpy(), jout[key])
    print(f"{key}: rel-L2 {err:.2e}")
    assert err <= tol
    assert np.abs(jout[key]).max() > 0


def test_chain_backbone_routes_each_stage_as_configured(backbone_run):
    """Which stages flow as int8 carries and which run the fused float links
    (the JAX module's precedence: a stage the int8 chain covers is no float
    stage)."""
    kwargs, tm, _, _, seen, _ = backbone_run
    depth = _int8_depth(kwargs)
    for n in (2, 3, 4, 5):
        out = seen[f"conv{n}_1"][1]
        assert isinstance(out, tuple) == (2 <= n <= depth), (n, depth)
        if isinstance(out, tuple):
            assert out[0].dtype == torch.int8 and out[2] == 127.0
    assert tm.fp == {n: kwargs.get("fp_stages", 0) >= n > max(depth, 1) for n in (2, 3, 4, 5)}


def _jax_block(name, kwargs):
    """The JAX module of one block of the backbone with the flags the JAX
    backbone gives it under ``kwargs`` (``backbone_s2d.py``, the calls of
    ``PillarRes18BackBone8xS2D.__call__``)."""
    from radardistill_tpu.models import backbone_s2d as jax_s2d
    from radardistill_tpu.models import backbone_sparse2d as jsp

    depth, fps, q = _int8_depth(kwargs), kwargs.get("fp_stages", 0), kwargs.get("int8", False)
    qs = {n: depth >= n for n in (1, 2, 3, 4, 5)}
    fp = {n: fps >= n and not qs[n] for n in (2, 3, 4, 5)}
    n = int(name[4])
    feats = {2: 64, 3: 128, 4: 256, 5: 256}[n]
    if name == "conv2_down":
        return jax_s2d.S2DDownBlock(32, 64, None, int8=q, int8_static=qs[1], int8_carry=qs[2])
    if name.endswith("down"):
        return jsp.SparseDownBlock(feats, None, int8=q, int8_static=qs[n - 1], int8_carry=qs[n],
                                   fp_block=fp[n])
    cls = jsp.DenseBasicBlock if n == 5 else jsp.SparseBasicBlock
    return cls(feats, None, int8=q, int8_static=qs[n], fp_block=fp[n])


@pytest.mark.parametrize("name", BLOCKS)
def test_chain_block_matches_jax_on_the_same_input(backbone_run, name):
    """Each block of stages 2-5 alone: the JAX block, with its flags under
    this configuration and its own variables, on the very input the port's
    block saw. An int8 carry out: codes within 1, differing on at most 1e-3 of
    the entries, the same bound; a float tensor out: within 1e-4 rel-L2, or,
    where the block ends a chain by requantizing and dequantizing, within one
    code's step on at most 1e-3 of the entries."""
    kwargs, tm, _, _, seen, variables = backbone_run
    args, out = seen[name]
    to_j = lambda t: (tuple(to_j(v) for v in t) if isinstance(t, tuple)  # noqa: E731
                      else jnp.asarray(t.numpy()) if torch.is_tensor(t) else t)
    x, mask = to_j(args[0]), (to_j(args[1]) if len(args) > 1 else None)
    sub = {k: v[name] for k, v in variables.items()}
    jblock = _jax_block(name, kwargs)
    if name.endswith("down"):
        jout = jblock.apply(sub, x, None, False, mask)[0]
    elif name.startswith("conv5"):
        jout = jblock.apply(sub, x, False)
    else:
        jout = jblock.apply(sub, x, mask, False)
    if isinstance(out, tuple):
        qj, bj, zj = jout
        diff = np.abs(out[0].numpy().astype(np.int32) - np.asarray(qj).astype(np.int32))
        share = float((diff != 0).mean())
        print(f"{name}: share of differing codes {share:.2e}")
        assert diff.max() <= 1 and share <= 1e-3
        assert float(out[1]) == pytest.approx(float(bj), rel=1e-6) and out[2] == zj == 127.0
        assert (np.asarray(qj) > -127).mean() > 0.01
        return
    want = np.asarray(jout, np.float32)
    got = out.numpy()
    assert got.shape == want.shape and np.abs(want).max() > 0
    ends_chain = isinstance(args[0], tuple) and name != "conv2_down"
    if ends_chain:
        step = float(getattr(tm, name).bn.affine()[2]) / 254.0  # one code of the carry
        diff = np.abs(got - want)
        assert diff.max() <= step * (1 + 1e-5) and float((diff > 1e-6).mean()) <= 1e-3
    else:
        assert _rel_l2(got, want) <= 1e-4


def test_v1_route_is_bit_equal_to_the_v2_route(backbone_inputs, monkeypatch):
    """``CONV_BLOCK_V1=1`` sends every link of the ``INT8_STAGES: 5`` chain
    through the first-generation link: the same codes, so the same features."""
    table, uids, masks, _, variables = backbone_inputs
    tm = load_jax_variables(s2d.PillarRes18BackBone8xS2D(
        (GRID, GRID), int8_static=True, int8_stages=5).eval(), variables)
    args = (torch.from_numpy(table), torch.from_numpy(uids),
            tuple(torch.from_numpy(m) for m in masks))
    calls = []
    real = ic.int8_block_conv
    spy = lambda *a, **k: calls.append(1) or real(*a, **k)  # noqa: E731
    monkeypatch.setattr(ic, "int8_block_conv", spy)
    monkeypatch.setattr(s2d, "int8_block_conv", spy)
    with torch.no_grad():
        v2 = tm(*args)
        assert len(calls) == 1  # the conv5 link alone
        monkeypatch.setenv("CONV_BLOCK_V1", "1")
        v1 = tm(*args)
    assert len(calls) == 1 + 24  # 23 dispatched links and the conv5 link
    for key in KEYS:
        assert torch.equal(v1[key], v2[key]), key


def test_frozen_teacher_in_train_mode_still_runs_its_chains(monkeypatch):
    """The chains are eval-only (``int8_static and not train`` in the JAX
    module); the detector keeps a frozen teacher's scopes in eval mode, so a
    student's train forward still runs them. Built from the yaml through
    ``make_batch``'s ``BACKBONE_3D`` overrides, as the card scripts do."""
    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.models.detector import batch_to_torch

    cfg, info, batch = make_batch(TRAIN_YAML, grid=128, num_lidar=4000, num_radar=300,
                                  num_boxes=10, backbone_3d={"INT8_STAGES": 3, "FP_STAGES": 5})
    assert cfg.BACKBONE_3D.INT8 == "static" and cfg.BACKBONE_3D.INT8_STAGES == 3
    model = layers.init_random_(build_network(cfg, info, device="cpu"),
                                torch.Generator().manual_seed(0))
    bb = model.backbone_3d
    assert bb.qs == {2: True, 3: True, 4: False, 5: False}
    assert bb.fp == {2: False, 3: False, 4: True, 5: True}
    seen, calls = {}, []
    bb.conv3_1.register_forward_hook(lambda mod, a, out: seen.__setitem__("x3", out))
    real = cb.fp_block_conv
    model.train()
    assert not bb.training and not bb.conv3_1.training and model.radar_backbone_3d.training
    stats = bb.conv4_1.bn1.running_mean.clone()
    import radardistill_tpu_torch.models.backbone_sparse2d as sp
    spy = lambda *a, **k: calls.append(1) or real(*a, **k)  # noqa: E731
    monkeypatch.setattr(sp, "fp_block_conv", spy)
    monkeypatch.setattr(s2d, "fp_block_conv", spy)
    out = model(batch_to_torch(batch, "cpu"))
    assert isinstance(seen["x3"], tuple) and seen["x3"][0].dtype == torch.int8
    # conv4_down ends the int8 chain; then 4 links of stage 4, the conv5 down
    # link and 4 links of stage 5 run fused in float
    assert len(calls) == 9
    assert torch.equal(bb.conv4_1.bn1.running_mean, stats)
    assert torch.isfinite(out["x_conv4"]).all() and torch.isfinite(out["x_conv5"]).all()
    assert not out["x_conv4"].requires_grad


def test_state_dict_does_not_depend_on_the_switches():
    base = s2d.PillarRes18BackBone8xS2D((GRID, GRID)).state_dict()
    for kwargs in CONFIGS.values():
        sd = s2d.PillarRes18BackBone8xS2D((GRID, GRID), **kwargs).state_dict()
        assert list(sd) == list(base)
        assert all(sd[k].shape == base[k].shape for k in base)


# ------------------------------------------------------- card-only (gpu)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FP_CASES + [dict(kh=3, w=37, c=64, co=32, res=True, h=19),
                                            dict(kh=2, w=20, c=512, co=256, res=False, nph=2)],
                         ids=_ids)
def test_fp_kernel_matches_plain_on_card(cuda, case, dtype, tol):
    link = _fp_link(30, **case)
    before = cb.conv_block_fp.launches
    got = _run_fp_torch(link, dtype, cuda)
    assert cb.conv_block_fp.launches == before + 1
    want = _run_fp_torch(link, dtype, cuda, block=cb.conv_block_fp_plain)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max() <= tol * want.float().abs().max()


# the seven link shapes of FP_STAGES: 5 (kernel, C, Co; chip_smoke.FP_LINKS) on
# a small odd grid, the 3x3 ones also with a residual, and a Co-64 link with
# a residual and a 2-phase mask; then Co-64 links on more tiles than the card
# has CTAs (2 x 90 x 2 = 360 tiles of the transposed kernel against 132 SMs
# on an H100), so both consumers of a CTA take tiles, with 2 chunks of the
# shared rings a tile (C 128) or 4 taps a chunk (kh 2)
FP_STAGE_CASES = [dict(kh=kh, w=37, c=c, co=co, res=res, h=19)
                  for kh, c, co, ress in ((3, 64, 64, (False, True)), (2, 256, 128, (False,)),
                                          (3, 128, 128, (False, True)), (2, 512, 256, (False,)),
                                          (3, 256, 256, (False, True)), (2, 1024, 256, (False,)))
                  for res in ress] + [dict(kh=3, w=45, c=64, co=64, res=True, nph=2, h=23),
                                      dict(kh=3, w=180, c=128, co=64, res=True, h=180),
                                      dict(kh=2, w=180, c=64, co=64, res=False, nph=2, h=180),
                                      dict(kh=3, w=180, c=64, co=64, res=True, h=180)]


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["wgmma", "mma_sync"])
@pytest.mark.parametrize("case", FP_STAGE_CASES, ids=_ids)
def test_fp_routes_match_plain_at_the_fp_stages_5_links(cuda, case, route):
    """K6 on both bfloat16 routes (forced) against its plain version, within
    1e-2 x max|ref|; the dispatch rule sends each of these links to
    ``wgmma``, and the launch counts on the route it took."""
    assert cb.fp_route_of(case["c"], case["co"], case.get("nph", 1), torch.bfloat16) == "wgmma"
    link = _fp_link(35, **case)
    routes = dict(cb.conv_block_fp.route_launches)
    got = _run_fp_torch(link, torch.bfloat16, cuda,
                        block=lambda *a: cb.conv_block_fp(*a, variant=route))
    assert cb.conv_block_fp.route_launches == {**routes, route: routes[route] + 1}
    want = _run_fp_torch(link, torch.bfloat16, cuda, block=cb.conv_block_fp_plain)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max() <= 1e-2 * want.float().abs().max()


@pytest.mark.gpu
def test_fp_forced_routes_raise_where_they_do_not_fit(cuda):
    link = _fp_link(36, kh=3, w=8, c=32, co=64, res=False)  # C 32: half a 128-byte chunk
    with pytest.raises(ValueError):
        _run_fp_torch(link, torch.bfloat16, cuda,
                      block=lambda *a: cb.conv_block_fp(*a, variant="wgmma"))
    link = _fp_link(36, kh=3, w=8, c=64, co=64, res=False)
    for dtype, variant in ((torch.float32, "wgmma"), (torch.float32, "mma_sync"),
                           (torch.bfloat16, "ffma"), (torch.bfloat16, "tiled")):
        with pytest.raises(ValueError):
            _run_fp_torch(link, dtype, cuda,
                          block=lambda *a, v=variant: cb.conv_block_fp(*a, variant=v))


@pytest.mark.gpu
@pytest.mark.parametrize("case", CHAIN_CASES + [dict(kh=2, zero=127.0, c=1024, co=256, h=9, w=10),
                                               dict(kh=3, zero=127.0, h=19, w=37, c=64, co=16)],
                         ids=_ids)
def test_chain_kernel_equals_plain_on_card(cuda, case):
    link = _link(31, **case)
    mq = (np.random.RandomState(32).rand(*link["xq"].shape[:3], link["kq"].shape[-1]) > 0.3
          ).astype(np.int8)
    before = ic.chain_conv.launches
    got = _run_chain_torch(link, mq, cuda)[0]
    assert ic.chain_conv.launches == before + 1
    want = _run_chain_torch(link, mq, cuda, block=ic.chain_conv_plain)[0]
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# K7 on its wgmma route: the conv5 link of INT8_STAGES: 5 (all-ones mask; 2 x
# 23 x 2 x 2 = 184 tiles of 4 x 64 pixels x 128 channels, more than an H100's
# 132 CTAs), a 3x3 90² 256 -> 256 link with a 60% per-channel mask and a
# residual, odd W, and a chain's first link (zpad 0)
CHAIN_WGMMA_CASES = [dict(kh=2, zero=127.0, c=1024, co=256, h=90, w=90, ones=True),
                     dict(kh=3, zero=127.0, c=256, co=256, h=90, w=90, with_res=True),
                     dict(kh=3, zero=127.0, c=128, co=128, h=19, w=37, with_res=True),
                     dict(kh=2, zero=0.0, c=256, co=384, h=13, w=65),
                     dict(kh=3, zero=0.0, c=128, co=256, h=5, w=7, with_res=True)]


@pytest.mark.gpu
@pytest.mark.parametrize("route", ic.ROUTES)
@pytest.mark.parametrize("case", CHAIN_WGMMA_CASES, ids=_ids)
def test_chain_routes_equal_plain_on_card(cuda, case, route):
    """Every code equal to ``chain_conv_plain``'s on both routes (forced);
    the dispatch rule sends these links to ``wgmma``; the launch counts on
    the route taken."""
    case = dict(case)
    ones = case.pop("ones", False)
    assert ic.chain_route_of(case["kh"], case["c"], case["co"]) == "wgmma"
    link = _link(37, **case)
    shape = (*link["xq"].shape[:3], link["kq"].shape[-1])
    mq = (np.ones(shape, np.int8) if ones
          else (np.random.RandomState(38).rand(*shape) < 0.6).astype(np.int8))
    routes = dict(ic.chain_conv.route_launches)
    got = _run_chain_torch(link, mq, cuda,
                           block=lambda *a, **k: ic.chain_conv(*a, variant=route, **k))[0]
    assert ic.chain_conv.route_launches == {**routes, route: routes[route] + 1}
    want = _run_chain_torch(link, mq, cuda, block=ic.chain_conv_plain)[0]
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert float((want > -127).float().mean()) > 0.1


@pytest.mark.gpu
@pytest.mark.parametrize("case", [CHAIN_WGMMA_CASES[0], CHAIN_WGMMA_CASES[1]], ids=_ids)
def test_chain_wgmma_route_equals_k1_on_an_all_ones_mask_on_card(cuda, case):
    """K7 on ``wgmma`` with an all-ones lane mask against K1 (``conv_block``,
    its ``wgmma`` route) with the one-phase mask of ones: every code equal."""
    case = {k: v for k, v in case.items() if k != "ones"}
    from tests.test_torch_conv_block import _run_torch

    link = _link(39, **case)
    link["mask"] = np.ones((*link["xq"].shape[:3], 1), np.int8)
    k7 = _run_chain_torch(link, _lane_mask(link), cuda)[0]
    k1 = _run_torch(link, None, cuda)[0]
    torch.cuda.synchronize()
    assert torch.equal(k7, k1)


@pytest.mark.gpu
def test_chain_wgmma_route_raises_where_it_does_not_fit(cuda):
    link = _link(40, kh=3, zero=127.0, c=64, co=128, h=8, w=8)  # C 64: half an int8 chunk
    with pytest.raises(ValueError, match="wgmma route"):
        _run_chain_torch(link, _lane_mask(link), cuda,
                         block=lambda *a, **k: ic.chain_conv(*a, variant="wgmma", **k))
    with pytest.raises(ValueError):
        _run_chain_torch(link, _lane_mask(link), cuda,
                         block=lambda *a, **k: ic.chain_conv(*a, variant="tiled", **k))


@pytest.mark.gpu
@pytest.mark.parametrize("case", [dict(kh=3, zero=127.0, c=256, co=256, h=20, w=24, with_res=True),
                                  dict(kh=2, zero=127.0, c=512, co=256, h=9, w=33),
                                  dict(kh=3, zero=0.0, nph=4, c=128, co=128, h=8, with_res=True)],
                         ids=_ids)
@pytest.mark.parametrize("deq_out", [None, torch.float32, torch.bfloat16])
def test_streamed_k1_equals_plain_on_card(cuda, case, deq_out):
    from tests.test_torch_conv_block import _run_torch

    link = _link(33, **case)
    streamed = lambda *a, **k: cb.conv_block(*a, variant="streamed", **k)  # noqa: E731
    got = _run_torch(link, deq_out, cuda, block=streamed)
    want = _run_torch(link, deq_out, cuda, block=cb.conv_block_plain)
    torch.cuda.synchronize()
    if deq_out is None:
        got, want = got[0], want[0]
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_float_kernels_raise_on_shapes_they_do_not_take(cuda):
    link = _fp_link(34, kh=3, w=8, c=24, co=48, res=False)  # Co 48: no tile of the bf16 kernel
    with pytest.raises(ValueError):
        _run_fp_torch(link, torch.bfloat16, cuda)
    link = _fp_link(34, kh=3, w=8, c=20, co=64, res=False)  # C 20: not a multiple of 8
    with pytest.raises(ValueError):
        _run_fp_torch(link, torch.float32, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("with_res", [False, True], ids=["first", "residual"])
def test_k1_at_the_packed_stage2_link_equals_plain_on_card(cuda, with_res):
    """The ``_S2D2`` teacher's packed stage-2 link: 3x3, C = Co = 256, 4 mask
    phases of 64 channels (a 128-channel tile of the epilogue spans two
    phases), 2 x 12 x 4 x 2 = 192 tiles of 4 x 64 pixels x 128 channels, more
    than the card's CTAs. Every code equal to the plain version's, on the
    ``wgmma`` route."""
    from tests.test_torch_conv_block import _run_torch

    link = _link(35, kh=3, zero=127.0 if with_res else 0.0, nph=4, c=256, co=256, h=48, w=200,
                 with_res=with_res)
    assert cb.route_of(3, 256, 256, 4, torch.int8) == "wgmma"
    before = cb.conv_block.route_launches["wgmma"]
    got = _run_torch(link, None, cuda)[0]
    assert cb.conv_block.route_launches["wgmma"] == before + 1
    want = _run_torch(link, None, cuda, block=cb.conv_block_plain)[0]
    torch.cuda.synchronize()
    assert torch.equal(got, want)
