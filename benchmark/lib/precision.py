"""The control's precision: the reference computed with every float product's
operands rounded to fp8.

The configurations state bfloat16 activations, so the nearest precision
below is fp8 (``float8_e4m3fn``). Inside :class:`Fp8Products` every
convolution and matrix product rounds its floating operands to e4m3, each
scaled by its own absolute maximum over the format's largest value (448),
computes in float32 and scales back; gradients pass the rounding
unchanged. Operands that hold only integers (the
int8 teacher's exact products, which its configuration states as int8) are
left as they are.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0
_PRODUCTS = {F.conv2d, F.conv_transpose2d, F.linear, torch.matmul, torch.mm, torch.bmm,
             torch.einsum, torch.Tensor.matmul, torch.Tensor.__matmul__, torch.Tensor.__rmatmul__,
             torch.Tensor.mm, torch.Tensor.bmm}


def to_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 at a per-tensor scale, back in ``t``'s dtype;
    integer-valued tensors unchanged."""
    if not (isinstance(t, torch.Tensor) and t.is_floating_point()) or t.numel() == 0:
        return t
    if torch.equal(t, torch.round(t)):
        return t
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    scale = E4M3_MAX / amax
    q = ((t.detach().float() * scale).to(torch.float8_e4m3fn).float() / scale).to(t.dtype)
    # the rounded value forward, the gradient straight through (an fp8 cast
    # has none of its own)
    return t + (q - t.detach())


class Fp8Products(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            args = tuple(to_fp8(a) if isinstance(a, torch.Tensor) else a for a in args)
        return func(*args, **kwargs)
