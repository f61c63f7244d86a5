"""K5: expand a row table to dense rows, ``dense[m] = table[inv[m]]``.

Counterpart of ``radardistill_tpu/ops/pallas_expand.py`` (``expand_rows``
dispatching to the Pallas ``expand_sorted_rows``). Entries of ``inv`` outside
``[0, R)`` give exact zero rows. The TPU kernel needed ``inv`` monotone within
each 512-cell block and the cells padded to that block; the CUDA kernel
(``csrc/expand.cu``) is a plain row gather with neither precondition.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
kernel, or raises if it cannot.
"""

from __future__ import annotations

import torch

from . import cuda_lib

DTYPES = (torch.float32, torch.bfloat16, torch.int8)


def expand_rows_plain(table: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``(M, C) = table[inv]`` with zero rows off the table."""
    r = table.shape[0]
    ok = (inv >= 0) & (inv < r)
    rows = table[inv.clamp(0, r - 1).long()]
    return torch.where(ok[:, None], rows, torch.zeros((), dtype=table.dtype, device=table.device))


def expand_rows(table: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """table (R, C) float32, bfloat16 or int8, rows a multiple of 16 bytes
    (C % 4 == 0 in float32, C % 8 == 0 in bfloat16, C % 16 == 0 in int8); inv
    (M,) int32 -> (M, C). The kernel copies raw 16-byte words, so every dtype
    is bit-exact."""
    if table.device.type == "cpu":
        return expand_rows_plain(table, inv)
    if table.device.type != "cuda" or inv.device != table.device:
        raise ValueError(f"expand_rows: table on {table.device}, inv on {inv.device}")
    if table.dtype not in DTYPES or inv.dtype != torch.int32:
        raise TypeError(f"expand_rows: table {table.dtype}, inv {inv.dtype}")
    if table.dim() != 2 or inv.dim() != 1:
        raise ValueError(f"expand_rows: table {tuple(table.shape)}, inv {tuple(inv.shape)}")
    if not (table.is_contiguous() and inv.is_contiguous()):
        raise ValueError("expand_rows: table and inv must be contiguous")
    m, (r, c) = inv.shape[0], table.shape
    row_bytes = c * table.element_size()
    if row_bytes % 16 or table.data_ptr() % 16:
        raise ValueError(f"expand_rows: the kernel moves 16-byte words; rows of {row_bytes} "
                         f"bytes at address {table.data_ptr():#x}")
    out = torch.empty((m, c), dtype=table.dtype, device=table.device)
    rc = cuda_lib.lib().rdt_expand_rows(
        table.data_ptr(), inv.data_ptr(), out.data_ptr(), m, r, row_bytes,
        table.device.index, cuda_lib.stream_of(table))
    cuda_lib.check(rc, "expand_rows")
    expand_rows.launches += 1
    return out


expand_rows.launches = 0
