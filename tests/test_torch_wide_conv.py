"""K9, the trainable 3x3 convolution, against the JAX package's
``conv3x3_wide`` (its Pallas kernel in interpret mode, as
``tests/test_wide_conv.py`` runs it), CPU; and (on a card) the CUDA kernel
against its plain version and autograd.

The same seeded numpy arrays go through both. Forward and both gradients in
float32 agree within 1e-5 x max|ref| (the same contraction in another order:
the JAX kernel sums three ky-stacked dots, and pairs the C = 64 case along
W), bfloat16 within 1e-2 x max|ref| (one bfloat16 rounding of the float32
sum). On the CPU the port takes its plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from radardistill_tpu.ops import pallas_wide_conv as jwc
from radardistill_tpu_torch.ops import conv_block as cb
from radardistill_tpu_torch.ops import wide_conv as wc


def _inputs(seed, h, w, ci, co, b=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, w, ci).astype(np.float32),
            (rng.randn(3, 3, ci, co) * 0.1).astype(np.float32),
            rng.randn(b, h, w, co).astype(np.float32))


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


SHAPES = [(8, 8, 128, 128), (12, 20, 128, 256), (6, 8, 256, 128),
          (8, 8, 64, 64), (12, 20, 64, 128)]  # the last two: W-paired on the JAX side


@pytest.mark.parametrize("h,w,ci,co", SHAPES)
def test_forward_f32_matches_pallas(h, w, ci, co):
    x, k, _ = _inputs(h * w + ci, h, w, ci, co)
    want = jwc.conv3x3_wide(jnp.asarray(x), jnp.asarray(k))
    before = wc.conv3x3_wide.launches, cb.conv_block_fp.launches
    got = wc.conv3x3_wide(torch.from_numpy(x), torch.from_numpy(k))
    assert (wc.conv3x3_wide.launches, cb.conv_block_fp.launches) == before
    assert got.dtype == torch.float32
    _close(got.numpy(), want, 1e-5)


def test_forward_bf16_matches_pallas():
    x, k, _ = _inputs(7, 16, 16, 128, 128, b=1)
    want = jwc.conv3x3_wide(jnp.asarray(x, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16))
    got = wc.conv3x3_wide(torch.from_numpy(x).bfloat16(), torch.from_numpy(k).bfloat16())
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), want, 1e-2)


@pytest.mark.parametrize("ci,co", [(128, 128), (64, 64)], ids=["c128", "c64-paired-in-jax"])
def test_gradients_match_pallas(ci, co):
    x, k, ct = _inputs(3 + ci, 8, 8, ci, co)
    loss = lambda x_, k_: jnp.vdot(jwc.conv3x3_wide(x_, k_), jnp.asarray(ct))  # noqa: E731
    gx, gk = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(k))
    xt = torch.from_numpy(x).requires_grad_()
    kt = torch.from_numpy(k).requires_grad_()
    tx, tk = torch.autograd.grad(wc.conv3x3_wide(xt, kt), (xt, kt), torch.from_numpy(ct))
    _close(tx.numpy(), gx, 1e-5)
    _close(tk.numpy(), gk, 1e-5)


def test_backward_is_the_same_conv_on_the_flipped_transposed_kernel():
    """The custom backward against autograd of a stock convolution, with a
    float32 kernel under bfloat16 activations (the gradient comes back in
    each argument's dtype)."""
    x, k, ct = _inputs(11, 6, 10, 16, 24)
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    kt = torch.from_numpy(k).requires_grad_()
    y = wc.conv3x3_wide(xt, kt)
    gx, gk = torch.autograd.grad(y, (xt, kt), torch.from_numpy(ct).bfloat16())
    assert y.dtype == gx.dtype == torch.bfloat16 and gk.dtype == torch.float32
    xr = xt.detach().float().requires_grad_()
    kr = kt.detach().bfloat16().float().requires_grad_()
    yr = F.conv2d(xr.permute(0, 3, 1, 2), kr.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
    rx, rk = torch.autograd.grad(yr, (xr, kr), torch.from_numpy(ct).bfloat16().float())
    _close(y.float().detach().numpy(), yr.detach().numpy(), 1e-2)
    _close(gx.float().numpy(), rx.numpy(), 1e-2)
    _close(gk.numpy(), rk.numpy(), 1e-5)


def test_plain_version_and_checks():
    x, k, _ = _inputs(12, 5, 7, 8, 12)
    xt, kt = torch.from_numpy(x), torch.from_numpy(k)
    want = F.conv2d(xt.permute(0, 3, 1, 2), kt.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
    _close(wc.conv3x3_wide_plain(xt, kt).numpy(), want.numpy(), 1e-6)
    with pytest.raises(ValueError):
        wc.conv3x3_wide(xt, kt[:2])
    with pytest.raises(ValueError):
        wc.conv3x3_wide(xt, torch.zeros(3, 3, 9, 12))


# ------------------------------------------------------- card-only (gpu)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    return torch.device("cuda", 0)


def _bf16_on_card(ci, co):
    """Shapes the bfloat16 card kernel takes for y and dx (else it raises)."""
    return ci % 128 == 0 and co % 128 == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("h,w,ci,co", SHAPES + [(19, 37, 64, 32)])
def test_kernel_matches_plain_and_autograd_on_card(cuda, h, w, ci, co, dtype, tol):
    torch.backends.cudnn.allow_tf32 = False
    x, k, ct = _inputs(20, h, w, ci, co)
    xt = torch.from_numpy(x).to(cuda, dtype).requires_grad_()
    kt = torch.from_numpy(k).to(cuda).requires_grad_()
    ctt = torch.from_numpy(ct).to(cuda, dtype)
    if dtype == torch.bfloat16 and not _bf16_on_card(ci, co):
        with pytest.raises(ValueError, match="conv3x3_wide"):
            torch.autograd.grad(wc.conv3x3_wide(xt, kt), (xt, kt), ctt)
        return
    before = wc.conv3x3_wide.launches, cb.conv_block_fp.launches
    y = wc.conv3x3_wide(xt, kt)
    gx, gk = torch.autograd.grad(y, (xt, kt), ctt)
    assert wc.conv3x3_wide.launches == before[0] + 2  # the forward and dx
    assert cb.conv_block_fp.launches == before[1]
    yr = wc.conv3x3_wide_plain(xt, kt)
    rx, rk = torch.autograd.grad(yr, (xt, kt), ctt)
    torch.cuda.synchronize()
    # dW: the kernel path accumulates it in float32; autograd through the plain
    # version rounds it to x's dtype on the way back through the kernel's cast
    for name, got, want, t in (("y", y, yr, tol), ("dx", gx, rx, tol),
                                 ("dW", gk, rk, max(tol, 1e-4))):
        err, ref = (got.float() - want.float()).abs().max(), want.float().abs().max()
        assert err <= t * ref, (name, float(err), float(ref))


# (B, H, W, C, Co): ragged H and W (tiles are 4 x 64 pixels), C 64-256, Co
# 128-512, B 1 and 2; C 64 takes the forward only (dx would have N = 64)
WGMMA_SHAPES = [(1, 19, 37, 64, 128), (2, 21, 70, 128, 128), (1, 6, 130, 256, 512),
                (2, 9, 64, 128, 256), (1, 3, 200, 256, 128), (2, 45, 45, 256, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w,ci,co", WGMMA_SHAPES)
def test_wgmma_route_matches_autograd_of_conv2d_on_card(cuda, b, h, w, ci, co):
    """bfloat16 y and dx on the TMA + wgmma mainloop against autograd through
    ``F.conv2d`` in float32 of the same bfloat16 values (TF32 off): within
    1e-2 x max|ref|, one bfloat16 rounding of a differently ordered sum."""
    torch.backends.cudnn.allow_tf32 = False
    x, k, ct = _inputs(b * h + w + ci, h, w, ci, co, b=b)
    with_dx = ci % 128 == 0
    xt = torch.from_numpy(x).to(cuda, torch.bfloat16).requires_grad_(with_dx)
    kt = torch.from_numpy(k).to(cuda, torch.bfloat16)
    ctt = torch.from_numpy(ct).to(cuda, torch.bfloat16)
    before = wc.conv3x3_wide.launches
    y = wc.conv3x3_wide(xt, kt)
    got = [y] + ([torch.autograd.grad(y, xt, ctt)[0]] if with_dx else [])
    assert wc.conv3x3_wide.launches == before + len(got)
    xr = xt.detach().float().requires_grad_()
    yr = F.conv2d(xr.permute(0, 3, 1, 2), kt.float().permute(3, 2, 0, 1),
                  padding=1).permute(0, 2, 3, 1)
    want = [yr] + ([torch.autograd.grad(yr, xr, ctt.float())[0]] if with_dx else [])
    torch.cuda.synchronize()
    for name, g, r in zip(("y", "dx"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == r.shape
        err, ref = (g.float() - r).abs().max().item(), r.abs().max().item()
        assert err <= 1e-2 * ref, (name, err, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("ci,co", [(32, 128), (128, 64), (96, 128)])
def test_wgmma_route_rejects_other_widths_on_card(cuda, ci, co):
    x = torch.zeros(1, 8, 8, ci, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="C % 64 == 0 and Co % 128 == 0"):
        wc.conv3x3_wide(x, torch.zeros(3, 3, ci, co, device=cuda))
