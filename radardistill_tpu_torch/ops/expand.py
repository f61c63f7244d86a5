"""K5 and K8: row gathers from a table, ``dense[m] = table[inv[m]]``.

Counterpart of ``radardistill_tpu/ops/pallas_expand.py`` (``expand_rows``
dispatching to the Pallas ``expand_sorted_rows``). Entries of ``inv`` outside
``[0, R)`` give exact zero rows. The TPU kernel needed ``inv`` monotone within
each 512-cell block and the cells padded to that block; the CUDA kernel
(``csrc/expand.cu``) is a plain row gather with neither precondition.

``gather_rows_windowed`` (K8, ``csrc/gather_win.cu``) is the counterpart of
``gather_rows_windowed`` + ``window_overflow`` of the same JAX module: the same
gather, but an entry also yields a zero row when it falls outside the window
of its aligned block of 512 entries, and such entries are counted. On the TPU
the window made the gather affordable; here it is only the function to
reproduce. Nothing in the model calls it, as in the JAX package. Its bare
launch ``launch_gather_win`` (nothing allocated, nothing counted) is what
``chip_smoke.py`` and ``tools/torch_gather_ab.py`` time alone. Neither may be
captured into a CUDA graph (both raise): the count's scratch word is kept per
stream, and a graph would bake one word into every replay.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
kernel, or raises if it cannot.
"""

from __future__ import annotations

import torch

from ..utils import profiler
from . import cuda_lib

DTYPES = (torch.float32, torch.bfloat16, torch.int8)


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


BLK = 512  # entries per window block


def _window(idx: torch.Tensor, r: int, n_win: int):
    """(active (M/BLK, BLK) bool, rel (M/BLK, BLK): idx minus its block's
    window start), with the table padded as the reference pads it."""
    if idx.shape[0] % BLK:
        raise ValueError(f"windowed gather: {idx.shape[0]} entries are not a multiple of {BLK}")
    r_full = _padded_rows(r, n_win)
    idx_b = idx.reshape(-1, BLK)
    active = (idx_b >= 0) & (idx_b < r)
    row_min = torch.where(active, idx_b, r_full).amin(dim=1)
    start = torch.div(row_min, BLK, rounding_mode="floor").clamp(0, r_full // BLK - n_win)
    return active, idx_b - start[:, None] * BLK


def _padded_rows(r: int, n_win: int) -> int:
    """Rows of the table after the reference's padding: to a multiple of BLK,
    and to at least (n_win + 1) blocks."""
    return max(r + (-r) % BLK, (n_win + 1) * BLK)


def window_overflow(idx: torch.Tensor, r: int, n_win: int) -> torch.Tensor:
    """Number of active entries of ``idx`` (in [0, r)) that fall outside their
    block's window of ``n_win`` blocks: the plain version of K8's count."""
    active, rel = _window(idx, r, n_win)
    return (active & (rel >= n_win * BLK)).sum().to(torch.int32)


def in_window(idx: torch.Tensor, r: int, n_win: int) -> torch.Tensor:
    """(M,) bool: the entries of ``idx`` whose row K8 copies (active and
    inside their block's window)."""
    active, rel = _window(idx, r, n_win)
    return (active & (rel >= 0) & (rel < n_win * BLK)).reshape(-1)


def gather_rows_windowed_plain(table: torch.Tensor, idx: torch.Tensor, n_win: int):
    """Plain PyTorch K8: (rows (M, C), overflow count). Unlike
    ``expand_rows_plain`` it zeroes the rows outside the window: for K8 the
    window is the function."""
    r = table.shape[0]
    ok = in_window(idx, r, n_win)
    rows = table[idx.clamp(0, r - 1).long()]
    rows = torch.where(ok[:, None], rows, torch.zeros((), dtype=table.dtype, device=table.device))
    return rows, window_overflow(idx, r, n_win)


def gather_rows_windowed_work(table: torch.Tensor, idx: torch.Tensor, n_win: int):
    """(flops, bytes) of one K8 call: a copy, no arithmetic; idx read once,
    each distinct row it copies read once (runs of entries repeat one row),
    every output row written once (PERF.md's bound of K8). The distinct rows
    are this call's: counting them reads idx back."""
    row = table.shape[1] * table.element_size()
    rows_read = torch.unique(idx[in_window(idx, table.shape[0], n_win)]).numel()
    return 0, idx.numel() * idx.element_size() + rows_read * row + idx.numel() * row


@profiler.counted("gather_rows_windowed", gather_rows_windowed_work)
def gather_rows_windowed(table: torch.Tensor, idx: torch.Tensor, n_win: int):
    """table (R, C) float32, bfloat16 or int8 with rows a multiple of 16
    bytes; idx (M,) int32, M a multiple of 512 -> (rows (M, C), overflow () int32).
    ``rows[m] = table[idx[m]]`` where idx[m] is in [0, R) and inside the
    window of its aligned block of 512 entries (``n_win`` blocks of the table
    from the block of the least active index, clipped to the padded table);
    exact zero rows elsewhere. ``overflow`` counts the active entries outside
    their window (what ``window_overflow`` computes); the kernel counts them
    in the same pass. Bit-exact in every dtype. On the card: the checks,
    two allocations and one launch (:func:`launch_gather_win`); not while
    the stream is captured into a CUDA graph."""
    if not table.is_cuda:
        if table.device.type == "cpu":
            return gather_rows_windowed_plain(table, idx, n_win)
        raise ValueError(f"gather_rows_windowed: table on {table.device}, idx on {idx.device}")
    index = table.get_device()
    if idx.get_device() != index:
        raise ValueError(f"gather_rows_windowed: table on {table.device}, idx on {idx.device}")
    if table.dtype not in DTYPES or idx.dtype != torch.int32:
        raise TypeError(f"gather_rows_windowed: table {table.dtype}, idx {idx.dtype}")
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"gather_rows_windowed: table {tuple(table.shape)}, idx "
                         f"{tuple(idx.shape)}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_rows_windowed: table and idx must be contiguous")
    m, (r, c) = idx.shape[0], table.shape
    row_bytes = c * table.element_size()
    if m % BLK or n_win < 1:
        raise ValueError(f"gather_rows_windowed: {m} entries (a multiple of {BLK}), n_win {n_win}")
    if row_bytes % 16 or table.data_ptr() % 16:
        raise ValueError(f"gather_rows_windowed: the kernel moves 16-byte words; rows of "
                         f"{row_bytes} bytes at address {table.data_ptr():#x}")
    out = table.new_empty((m, c))
    overflow = idx.new_empty(())
    _launch(_launch_fn or _bind(), table, idx, out, overflow, m, r, row_bytes, n_win, index)
    gather_rows_windowed.launches += 1
    return out, overflow


gather_rows_windowed.launches = 0

# the kernel's 8-byte word (tickets, sum) per (device, stream), zero between
# launches: made once, and each launch's last CTA zeroes it again. Launches on
# one stream run in order, so they never share it in flight; a captured graph
# would replay one word on any stream, so _launch refuses capture. Values:
# (the tensor, its address).
_scratch: dict = {}
_launch_fn = None


def _bind():
    global _launch_fn
    _launch_fn = cuda_lib.lib().rdt_gather_rows_windowed
    return _launch_fn


def _launch(fn, table, idx, out, overflow, m, r, row_bytes, n_win, index):
    if torch._C._cuda_isCurrentStreamCapturing():
        raise RuntimeError("gather_rows_windowed: the count's scratch word is kept per stream; "
                           "the kernel cannot be captured into a CUDA graph")
    stream = torch._C._cuda_getCurrentRawStream(index)
    scratch = _scratch.get((index, stream))
    if scratch is None:
        t = torch.zeros(2, dtype=torch.int32, device=table.device)
        scratch = _scratch[index, stream] = (t, t.data_ptr())
    rc = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(), overflow.data_ptr(), scratch[1], m,
            r, _padded_rows(r, n_win), n_win, row_bytes, index, stream)
    if rc:
        cuda_lib.check(rc, "gather_rows_windowed")


def launch_gather_win(table: torch.Tensor, idx: torch.Tensor, n_win: int, out: torch.Tensor,
                      overflow: torch.Tensor, lib=None) -> None:
    """One launch of K8 into ``out`` (M, C) and ``overflow`` (() int32, written
    whole), nothing allocated (but the count's scratch, once per device and
    stream) and nothing counted; raises under CUDA graph capture. The caller
    has checked what :func:`gather_rows_windowed` checks. ``lib``: another
    build of this kernel (bound with ``cuda_lib.bind``), else the package's."""
    fn = lib.rdt_gather_rows_windowed if lib is not None else _launch_fn or _bind()
    m, (r, c) = idx.shape[0], table.shape
    _launch(fn, table, idx, out, overflow, m, r, c * table.element_size(), n_win,
            table.get_device())
