"""K5: a row gather from a table, ``dense[m] = table[inv[m]]``, in the
reference copy: its plain version on every device, and its count.
Entries of ``inv`` outside ``[0, R)`` give exact zero rows."""

from __future__ import annotations

import torch

from ..utils import profiler


def expand_rows_plain(table: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``(M, C) = table[inv]`` with zero rows off the table."""
    r = table.shape[0]
    ok = (inv >= 0) & (inv < r)
    rows = table[inv.clamp(0, r - 1).long()]
    return torch.where(ok[:, None], rows, torch.zeros((), dtype=table.dtype, device=table.device))


def expand_rows_work(table: torch.Tensor, inv: torch.Tensor):
    """(flops, bytes) of one K5 call: a copy, no arithmetic; inv read, the
    table read once, the rows written (PERF.md's bound of K5)."""
    rows = inv.shape[0] * table.shape[1] * table.element_size()
    return 0, table.numel() * table.element_size() + inv.numel() * inv.element_size() + rows


@profiler.counted("expand_rows", expand_rows_work)
def expand_rows(table: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """table (R, C) float32, bfloat16 or int8, rows a multiple of 16 bytes
    (C % 4 == 0 in float32, C % 8 == 0 in bfloat16, C % 16 == 0 in int8); inv
    (M,) int32 -> (M, C). The kernel copies raw 16-byte words, so every dtype
    is bit-exact."""
    return expand_rows_plain(table, inv)
