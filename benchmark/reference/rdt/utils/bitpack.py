"""Bool-grid bit packing between the host precompute and the model.

The port's copy of ``radardistill_tpu/utils/bitpack.py``: the host packs bool
grids along the last (W) axis with numpy's default MSB-first bit order (8x
fewer bytes to move to the card), and the model unpacks them with three
elementwise tensor ops.
"""

from __future__ import annotations

import numpy as np
import torch


def pack_bool_np(m: np.ndarray) -> np.ndarray:
    """(…, W) bool -> (…, ceil(W/8)) uint8, MSB-first (np.packbits)."""
    return np.packbits(m, axis=-1)


def unpack_bool(p: torch.Tensor, w: int) -> torch.Tensor:
    """(…, ceil(W/8)) uint8 tensor -> (…, w) bool (matches pack_bool_np)."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=p.device)  # MSB first
    bits = (p[..., :, None] >> shifts) & 1
    return bits.reshape(*p.shape[:-1], p.shape[-1] * 8)[..., :w].bool()
