"""Data parallelism in the reference copy: one process over the whole batch.

The program's ``parallel/mesh.py`` sums the BNs' statistics and the losses'
batch normalizers over its ranks through ``batch_sum`` inside a
``sync_batch`` scope. The reference runs one process over the global batch,
so ``batch_sum`` is the identity and there is no group.
"""

from __future__ import annotations

import torch


def sync_group():
    """The process group the BNs synchronize over: none."""
    return None


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x``: one process holds the whole batch."""
    return x
