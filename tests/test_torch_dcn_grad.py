"""The port's DCN backward (K3 ``dcn_offset_grad``, K4 ``dcn_input_grad``, the
differentiable ``modulated_deform_conv``) and the active-site backward passes
against the JAX package, float32, CPU.

Here the port takes its plain versions; the JAX side runs its Pallas kernels
in interpret mode (the clamped leg) or differentiates its XLA formulation
(the unclamped leg). Inputs are made from a seed with numpy.

Tolerances: K3, K4 within 1e-5 x max|ref| (float32 summation order: the
Pallas kernels reduce through one-hot matmuls over a window, the plain
versions over four corner gathers); whole-DCN gradients rel-L2 <= 1e-4; the
active-site backward passes are pure row gathers and agree to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radardistill_tpu.ops import active_site as jasx
from radardistill_tpu.ops import pallas_dcn as jpdcn
from radardistill_tpu.ops.dcn import _modulated_deform_conv_xla
from radardistill_tpu_torch.ops import active_site as asx
from radardistill_tpu_torch.ops import dcn, dcn_grad
from radardistill_tpu_torch.ops.dcn_sample import corner_terms, dcn_sample_plain

# Six xdist workers share the machine's cores: one intra-op thread per worker
# keeps torch's thread pools from oversubscribing them (the suite is bound by
# its total CPU time). The tolerances here hold for any thread count.
torch.set_num_threads(1)


def _case(seed, h, c, co=32, off_scale=3.0, b=1):
    rng = np.random.RandomState(seed)
    ho = h // 2
    x = rng.randn(b, h, h, c).astype(np.float32)
    offset = (off_scale * rng.randn(b, ho, ho, 18)).astype(np.float32)
    mask = (rng.rand(b, ho, ho, 9) * 0.9 + 0.05).astype(np.float32)
    weight = (rng.randn(3, 3, c, co) / np.sqrt(9 * c)).astype(np.float32)
    dsampled = rng.randn(b, ho, ho, 9 * c).astype(np.float32)
    return x, offset, mask, weight, dsampled


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.fixture(scope="module", params=[5, 8], ids=["R5", "R8"])
def kernel_case(request):
    """B 1, 90², C 128: a shape the Pallas kernels take; part of the offsets
    lies beyond the clamp."""
    r = request.param
    x, offset, mask, _, ds = _case(10 + r, 90, 128)
    assert (np.abs(offset) > r).mean() > 0.005
    return r, x, offset, mask, ds


def test_offset_grad_plain_matches_pallas(kernel_case):
    r, x, offset, mask, ds = kernel_case
    wo = offset.shape[2]
    pad = lambda a: np.pad(a, ((0, 0), (0, 0), (0, -wo % jpdcn.OC), (0, 0)))  # noqa: E731
    g18_j, dm9_j = jpdcn.dcn_offset_grad(
        jnp.asarray(x), jnp.asarray(offset), jnp.asarray(pad(ds)), jnp.asarray(pad(mask)),
        stride=2, padding=1, max_offset=r, interpret=True)
    g18, dm9 = dcn_grad.dcn_offset_grad(*map(torch.from_numpy, (x, offset, ds, mask)),
                                        2, 1, 3, float(r))
    _close(g18.numpy(), np.asarray(g18_j)[:, :, :wo])
    _close(dm9.numpy(), np.asarray(dm9_j)[:, :, :wo])


def test_input_grad_plain_matches_pallas(kernel_case):
    r, x, offset, mask, ds = kernel_case
    dx_j = jpdcn.dcn_input_grad(jnp.asarray(ds), jnp.asarray(offset), jnp.asarray(mask), 90, 90,
                                stride=2, padding=1, max_offset=r, interpret=True)
    dx = dcn_grad.dcn_input_grad(*map(torch.from_numpy, (ds, offset, mask)), 90, 90,
                                 2, 1, 3, float(r))
    _close(dx.numpy(), dx_j)


@pytest.mark.parametrize("max_offset", [5.0, None], ids=["clamped", "unclamped"])
def test_plain_grads_match_autograd_of_plain_sampling(max_offset):
    """K3 and K4's plain versions are the vector-Jacobian products of
    ``dcn_sample_plain``; offsets exactly at 0 (integer positions) and exactly
    at the clamp are among the inputs."""
    x, offset, mask, _, ds = _case(3, 20, 16)
    offset[0, 0, 0, :6] = 0.0
    offset[0, 1, 1, 0], offset[0, 1, 1, 1] = 5.0, 5.0
    xt, ot, mt = (torch.from_numpy(a).requires_grad_() for a in (x, offset, mask))
    dst = torch.from_numpy(ds)
    sampled = dcn_sample_plain(xt, ot, mt, 2, 1, 3, max_offset)
    gx, go, gm = torch.autograd.grad(sampled, (xt, ot, mt), dst)
    args = (2, 1, 3, max_offset)
    g18, dm9 = dcn_grad.dcn_offset_grad(xt.detach(), ot.detach(), dst, mt.detach(), *args)
    if max_offset is not None:
        g18 = g18 * (ot.detach().abs() <= max_offset)
    dx = dcn_grad.dcn_input_grad(dst, ot.detach(), mt.detach(), 20, 20, *args)
    _close(g18, go)
    _close(dm9, gm)
    _close(dx, gx)
    assert float(go[0, 1, 1, 0]) != 0.0  # |offset| == R passes its gradient


def _port_grads(x, offset, mask, weight, cot):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, offset, mask, weight)]
    y = dcn.modulated_deform_conv(*leaves, stride=2, padding=1)
    return [g.numpy() for g in torch.autograd.grad(y, leaves, torch.from_numpy(cot))]


def test_dcn_gradients_clamped_match_pallas():
    """Gate-true shape: the four gradients against ``jax.grad`` through the
    Pallas kernels; offsets beyond +-5 get exactly zero gradient."""
    x, offset, mask, weight, _ = _case(20, 40, 128)
    assert dcn.shapes_supported(x.shape, offset.shape, 2, 1, 3)
    beyond = np.abs(offset) > 5
    assert beyond.mean() > 0.05
    cot = np.random.RandomState(21).randn(1, 20, 20, 32).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jpdcn.modulated_deform_conv_mxu(*a, 2, 1, 5, True) * cot),
                    argnums=(0, 1, 2, 3))(*map(jnp.asarray, (x, offset, mask, weight)))
    got = _port_grads(x, offset, mask, weight, cot)
    for g, w in zip(got, want):
        assert _rel_l2(g, w) <= 1e-4
    assert np.all(got[1][beyond] == 0.0) and np.any(got[1][~beyond] != 0.0)
    assert np.any(got[2][beyond[..., ::2]] != 0.0)  # dmask is not gated


def test_dcn_gradients_unclamped_match_xla():
    """Gate-false shape (H % 10 != 0): no clamp, gradients of the reference's
    XLA formulation; offsets beyond 5 keep their gradient."""
    x, offset, mask, weight, _ = _case(22, 24, 64, off_scale=4.0)
    assert not dcn.shapes_supported(x.shape, offset.shape, 2, 1, 3)
    cot = np.random.RandomState(23).randn(1, 12, 12, 32).astype(np.float32)
    want = jax.grad(
        lambda *a: jnp.sum(_modulated_deform_conv_xla(*a, stride=2, padding=1) * cot),
        argnums=(0, 1, 2, 3))(*map(jnp.asarray, (x, offset, mask, weight)))
    got = _port_grads(x, offset, mask, weight, cot)
    for g, w in zip(got, want):
        assert _rel_l2(g, w) <= 1e-4
    assert np.any(got[1][np.abs(offset) > 5] != 0.0)


def test_dcn_zero_offset_gradients_are_a_convs():
    """Offsets exactly 0 and unit mask: x and weight gradients are those of
    the plain strided conv (the derivative at integer positions follows
    ``floor`` and does not disturb them)."""
    rng = np.random.RandomState(2)
    x = rng.randn(1, 12, 14, 16).astype(np.float32)
    w = rng.randn(3, 3, 16, 8).astype(np.float32)
    cot = rng.randn(1, 6, 7, 8).astype(np.float32)
    got = _port_grads(x, np.zeros((1, 6, 7, 18), np.float32), np.ones((1, 6, 7, 9), np.float32),
                      w, cot)
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    y = torch.nn.functional.conv2d(xt.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1),
                                   stride=2, padding=1).permute(0, 2, 3, 1)
    gx, gw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(cot))
    _close(got[0], gx)
    _close(got[3], gw)


# ------------------------------------------- K4's tile route: window and route


def _windowed_corners(stride, max_offset, h, seed):
    """Every on-grid corner that ``corner_terms`` gives for offsets of which
    a tenth sit on the clamp at exactly ±R, a tenth are whole numbers and a
    few are NaN: (site row, corner row, site column, corner column)."""
    rng = np.random.RandomState(seed)
    ho = h // stride
    off = 3.0 * rng.randn(2, ho, ho, 18)
    pick = rng.rand(*off.shape)
    off = np.where(pick < 0.1, np.sign(off) * max_offset, off)
    off = np.where((pick >= 0.1) & (pick < 0.2), np.round(off), off)
    off = np.where(pick > 0.99, np.nan, off).astype(np.float32)
    mask = np.ones((2, ho, ho, 9), np.float32)
    _, _, _, corners = corner_terms((2, h, h, 1), torch.from_numpy(off), torch.from_numpy(mask),
                                    stride, 1, 3, max_offset)
    site_r = np.broadcast_to(np.arange(ho)[None, :, None, None], (2, ho, ho, 9))
    site_q = np.broadcast_to(np.arange(ho)[None, None, :, None], (2, ho, ho, 9))
    out = []
    for _, _, ok, rows in corners:
        ok = ok.numpy()
        cell = rows.numpy() % (h * h)
        out.append((site_r[ok], cell[ok] // h, site_q[ok], cell[ok] % h))
    return [np.concatenate(a) for a in zip(*out)], ho


@pytest.mark.parametrize("stride", [2, 1])
@pytest.mark.parametrize("max_offset", [5.0, 4.5, 8.0])
def test_reach_window_holds_every_corner(stride, max_offset):
    """Every on-grid corner lies in a tile whose windows, in the table the
    wrapper passes to the tile kernel, hold the corner's site on both axes;
    a window one output row shorter at either end misses some; and the
    kernel's shared memory holds every (site, tap) of a tile's window."""
    h = 90
    (sr, r, sq, q), ho = _windowed_corners(stride, max_offset, h, 30 + stride)
    assert len(r) > 10000
    th, tw = dcn_grad.tile_plan(h, h)[:2]
    table, cap = dcn_grad.tile_windows(h, h, ho, ho, stride, 1, 3, max_offset, th, tw, "cpu")
    win = table.numpy().reshape(-1, 2)
    n_tr = -(-h // th)
    for site, tile, axis in ((sr, r // th, win[:n_tr]), (sq, q // tw, win[n_tr:])):
        first, last = axis[tile, 0], axis[tile, 1]
        assert ((first <= site) & (site <= last)).all()
        assert ((site == first) & (first > 0)).any()  # a window from first + 1 misses these
        assert ((site == last) & (last < ho - 1)).any()  # one to last - 1 misses these
    span = (win[:, 1] - win[:, 0] + 1)
    assert span[:n_tr].max() * span[n_tr:].max() * 9 == cap


def test_tile_windows_at_the_cma_site():
    """The table the kernel reads at the CMA's 180² -> 90² site: one [first,
    last] pair per tile row of 8, then per tile column of 8."""
    assert dcn_grad.tile_plan(180, 180) == (8, 8, 8)
    table, cap = dcn_grad.tile_windows(180, 180, 90, 90, 2, 1, 3, 5.0, 8, 8, "cpu")
    t = table.tolist()
    pairs = list(zip(t[::2], t[1::2]))
    assert len(pairs) == 23 + 23 and pairs[:23] == pairs[23:]
    assert pairs[:3] == [(0, 6), (1, 10), (5, 14)] and pairs[22] == (85, 89)
    assert cap == 9 * 10 * 10  # rows 8-15 reach output rows 1-10


def test_input_grad_route():
    """Clamped calls take the tile kernel where it takes the channels; the
    unclamped leg (no window) the atomic kernel."""
    route = dcn_grad.input_grad_route
    for dtype in (torch.float32, torch.bfloat16):
        assert route(5.0, 2, 1, 256, dtype) == "tile"
        assert route(5, 1, 1, 72, dtype) == "tile"
        assert route(None, 2, 1, 256, dtype) == "atomic"
        assert route(5.0, 2, 1, 36, dtype) == "atomic"  # not whole 16-byte vectors
    assert route(float("inf"), 2, 1, 256, torch.float32) == "atomic"
    # with the geometry, the tile route also needs its window in shared
    # memory: at R = 8 both strides fit (the CMA's stride 2 in 41 KB), at
    # stride 1 a clamp of 20 does not
    smem = {}
    for stride, r, h in ((2, 5.0, 180), (2, 8.0, 180), (1, 5.0, 90), (1, 8.0, 90),
                         (1, 20.0, 90)):
        ho = h // stride
        th, tw, _ = dcn_grad.tile_plan(h, h)
        cap = dcn_grad.tile_windows(h, h, ho, ho, stride, 1, 3, r, th, tw, "cpu")[1]
        smem[stride, r] = dcn_grad.tile_smem_bytes(cap, th, tw)
        want = "tile" if smem[stride, r] <= dcn_grad.TILE_SMEM_LIMIT else "atomic"
        assert route(r, stride, 1, 256, torch.bfloat16, (h, h, ho, ho, 3)) == want
    assert smem == {(2, 5.0): 22572, (2, 8.0): 43308, (1, 5.0): 96228, (1, 8.0): 158436,
                    (1, 20.0): 562788}
    assert [dcn_grad.tile_plan(h, w) for h, w in ((180, 180), (90, 45), (7, 64))] == [
        (8, 8, 8), (8, 8, 8), (7, 8, 8)]


# ------------------------------------------------- active-site backward passes


def _tap_case(seed, b=2, hw=(12, 12), cap=64, c=8):
    rng = np.random.RandomState(seed)
    h, w = hw
    uids = np.full((b, cap), h * w, np.int32)
    for i in range(b):
        n = rng.randint(cap // 2, cap - 4)
        uids[i, :n] = np.sort(rng.choice(h * w, n, replace=False))
    ju = jnp.asarray(uids)
    grid = jax.vmap(lambda u: jasx.site_index_grid(u, h * w, cap))(ju)
    nb, msk = jasx.conv_neighbor_table_b(ju, grid, hw, w, 1, cap)
    inv, imsk = jasx.invert_taps_b(nb, msk, cap)
    feats = rng.randn(b, cap, c).astype(np.float32)
    return uids, feats, tuple(np.asarray(t) for t in (nb, msk, inv, imsk))


def test_gather_taps_inv_b_backward_matches_jax():
    _, feats, tap = _tap_case(0)
    cot = np.random.RandomState(1).randn(2, 9, 64, 8).astype(np.float32)
    out_j, vjp = jax.vjp(lambda f: jasx.gather_taps_inv_b(f, *map(jnp.asarray, tap)),
                         jnp.asarray(feats))
    (want,) = vjp(jnp.asarray(cot))
    ft = torch.from_numpy(feats).requires_grad_()
    out = asx.gather_taps_inv_b(ft, *(torch.from_numpy(t) for t in tap))
    (got,) = torch.autograd.grad(out, ft, torch.from_numpy(cot))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(out_j))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    # the gather form gives what autograd's scatter-add of the index op gives
    ft2 = torch.from_numpy(feats).requires_grad_()
    plain = asx._flat_tap_gather(ft2, torch.from_numpy(tap[0])) * torch.from_numpy(
        tap[1])[..., None].float()
    (ref,) = torch.autograd.grad(plain, ft2, torch.from_numpy(cot))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-6)


def test_densify_batch_backward_matches_jax():
    uids, feats, _ = _tap_case(2)
    cot = np.random.RandomState(3).randn(2, 12, 12, 8).astype(np.float32)
    (dense_j, _), vjp = jax.vjp(
        lambda f: jasx.densify_batch(f, jnp.asarray(uids), (12, 12)), jnp.asarray(feats))
    (want,) = vjp((jnp.asarray(cot), np.zeros((2, 12, 12), jax.dtypes.float0)))
    ft = torch.from_numpy(feats).requires_grad_()
    dense, mask = asx.densify_batch(ft, torch.from_numpy(uids), (12, 12))
    (got,) = torch.autograd.grad(dense, ft, torch.from_numpy(cot))
    np.testing.assert_array_equal(dense.detach().numpy(), np.asarray(dense_j))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not mask.requires_grad and got[uids >= 144].abs().max() == 0
