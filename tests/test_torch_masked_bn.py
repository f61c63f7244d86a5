"""The gradients of the port's train-mode ``MaskedBatchNorm``, whose backward
is written by hand (``layers._MaskedBatchNormTrain``), on the CPU: dx,
dweight and dbias against ``jax.grad`` of the JAX package's
``MaskedBatchNorm`` and against autograd of the float32 expression the
port computed before (the statistics of the masked rows, differentiated
through), for the same masked input and the same cotangent.

Cases: a float32 map with a third of its rows inactive; every row inactive
(``n`` clamps to 1); a channel constant over the active rows (its variance
before the clamp is exactly 0); bfloat16 x. The JAX module multiplies a
bfloat16 x in bfloat16 before it sums, where the port sums in float32, so
the bfloat16 case is held against the float32 expression only.

Tolerances: float32 rtol 1e-5 with an absolute floor of 1e-6 x max|ref|
(summation order); the bfloat16 dx within one bfloat16 rounding (2^-8) of
the float32 expression's, itself rounded once to bfloat16. The group branch
of the backward (inside a ``sync_batch`` scope) is checked on two ranks in
``tests/test_torch_parallel.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radardistill_tpu.models.layers import MaskedBatchNorm as JMaskedBatchNorm
from radardistill_tpu_torch.models.layers import MaskedBatchNorm
from tests.torch_parallel_worker import masked_bn_inputs

EPS, MOMENTUM = 1e-3, 0.01
CASES = ("float32", "all_inactive", "constant_channel", "bfloat16")


def previous_expression(x, mask, weight, bias, eps=EPS):
    """The train forward the port computed before its backward was written
    by hand: float32 statistics of the masked rows, autograd through all."""
    x32, m = x.float(), mask.to(torch.float32)
    axes = tuple(range(x.dim() - 1))
    xm = x32 * m[..., None]
    n = torch.clamp(m.sum(), min=1.0)
    mean = xm.sum(dim=axes) / n
    var = torch.clamp((xm * x32).sum(dim=axes) / n - mean * mean, min=0.0)
    return ((x32 - mean) * torch.rsqrt(var + eps) * weight + bias).to(x.dtype)


def autograd_grads(x, mask, gy, weight, bias):
    """dx, dweight, dbias of ``previous_expression``."""
    x = x.detach().requires_grad_()
    w, b = (torch.from_numpy(a).requires_grad_() for a in (weight, bias))
    y = previous_expression(x, mask, w, b)
    y.backward(gy.to(y.dtype))
    return x.grad, w.grad, b.grad


def bn_grads(x, mask, gy, weight, bias):
    """dx, dweight, dbias of the port's module in train mode."""
    bn = MaskedBatchNorm(x.shape[-1], eps=EPS, momentum=MOMENTUM).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    x = x.detach().requires_grad_()
    y = bn(x, mask)
    y.backward(gy.to(y.dtype))
    return x.grad, bn.weight.grad, bn.bias.grad


def _jax_loss(x, mask, gy, scale, bias):
    stats = {"mean": jnp.zeros(x.shape[-1]), "var": jnp.ones(x.shape[-1])}
    y, _ = JMaskedBatchNorm(eps=EPS, momentum=MOMENTUM).apply(
        {"params": {"scale": scale, "bias": bias}, "batch_stats": stats}, x, mask, True,
        mutable=["batch_stats"])
    return jnp.sum(y * gy)


# one compile for the float32 cases (same shapes)
_jax_grad = jax.jit(jax.grad(_jax_loss, argnums=(0, 3, 4)))


def jax_grads(x, mask, gy, weight, bias):
    return [np.asarray(g) for g in _jax_grad(x, mask, gy, weight, bias)]


def assert_close(got, want, err_msg=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max(), err_msg=err_msg)


@pytest.mark.parametrize("case", CASES)
def test_masked_bn_backward_matches_jax_and_autograd(case):
    x, mask, gy, weight, bias = masked_bn_inputs(case)
    dtype = torch.bfloat16 if case == "bfloat16" else torch.float32
    tx = torch.from_numpy(x).to(dtype)
    tmask, tgy = torch.from_numpy(mask), torch.from_numpy(gy)
    got = bn_grads(tx, tmask, tgy, weight, bias)
    assert got[0].dtype == dtype
    before = autograd_grads(tx, tmask, tgy, weight, bias)
    for name, g, w in zip(("dx", "dweight", "dbias"), got, before):
        if name == "dx" and dtype == torch.bfloat16:
            np.testing.assert_allclose(g.float().numpy(), w.float().numpy(), rtol=2.0 ** -8,
                                       atol=2.0 ** -8 * w.float().abs().max().item())
        else:
            assert_close(g.numpy(), w.numpy(), name)
    if dtype == torch.bfloat16:
        return
    for name, g, w in zip(("dx", "dweight", "dbias"), got, jax_grads(x, mask, gy, weight, bias)):
        assert_close(g.numpy(), w, name)
    if case == "all_inactive":  # nothing to normalize by: no gradient through the statistics
        inv = 1.0 / np.sqrt(EPS)  # n = 1, mean 0, variance 0
        assert_close(got[0].numpy(), gy * weight * inv)
    if case == "constant_channel":
        xm = x[..., 2][mask].astype(np.float64)
        assert np.mean(xm ** 2) - np.mean(xm) ** 2 == 0.0
