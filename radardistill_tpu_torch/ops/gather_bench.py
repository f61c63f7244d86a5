"""K8 (``expand.gather_rows_windowed``) on the card at the 14 gathers the
student's tap tables give it: ``chip_smoke.py``'s K8 phase and
``tools/torch_gather_ab.py`` build their cases and time them here.

A case is one tap table of the bs2 train batch read as the active-site convs
would read it, bfloat16: forward, rows of the feature table at ``nb``;
backward, rows of the cotangent at ``inv``. Its ``n_win`` is the least window
with no overflow, so the kernel, the plain version and the unwindowed
``torch.index_select`` must agree bit for bit, with a count of 0. Each case is
timed four ways, in turns: the wrapper as a caller meets it (host included),
the bare launch with the host's enqueue hidden (the device's time), the plain
version, and ``index_select`` (the library call, which has no window); then
the bare launch once more with L2 emptied before each call, since back-to-back
launches find most tables in L2.
"""

from __future__ import annotations

import functools

import torch

from . import expand
from .probe_bench import PEAK_BYTES, cuda_ms

# input channels of the conv that reads each tap table
TAP_CHANNELS = {"tap1": 32, "dtap2": 32, "tap2": 64, "dtap3": 64, "tap3": 128, "dtap4": 128,
                "tap4": 256}


def tap_gathers(tables, gen: torch.Generator):
    """The 14 cases from ``build_tables``' tap tables (on the card): dicts of
    name, direction, table (rows, C) bfloat16, idx (M,) int32, n_win."""
    cases = []
    for name, c in TAP_CHANNELS.items():
        nb, _, inv, _ = tables[name]
        dev = nb.device
        b, k, cap_out = nb.shape
        cap_in = inv.shape[2]
        fwd_idx = nb + (torch.arange(b, device=dev, dtype=torch.int32) * cap_in)[:, None, None]
        seg = (torch.arange(b * k, device=dev, dtype=torch.int32) * cap_out).reshape(b, k, 1)
        for direction, idx, rows in (("forward", fwd_idx, b * cap_in),
                                     ("backward", inv + seg, b * k * cap_out)):
            idx = idx.reshape(-1).to(torch.int32).contiguous()
            table = torch.randn(rows, c, generator=gen).to(dev, torch.bfloat16)
            n_win = next(n for n in range(1, rows // expand.BLK + 2)
                         if int(expand.window_overflow(idx, rows, n)) == 0)
            cases.append({"name": name, "direction": direction, "table": table, "idx": idx,
                          "n_win": n_win})
    return cases


def bound_bytes(case) -> int:
    """What the gather must move: idx read once, each distinct row it copies
    read once (the tap tables fill their holes forward, so runs of entries
    repeat one row), every output row written once."""
    return expand.gather_rows_windowed_work(case["table"], case["idx"], case["n_win"])[1]


def check_case(case):
    """Wrapper == bare launch == plain == ``index_select``, counts 0; returns
    the wrapper's rows."""
    table, idx, n_win = case["table"], case["idx"], case["n_win"]
    got, over = expand.gather_rows_windowed(table, idx, n_win)
    want, over_p = expand.gather_rows_windowed_plain(table, idx, n_win)
    lib = torch.index_select(table, 0, idx.long())  # no window: every idx is a row
    bare, over_b = torch.empty_like(got), torch.full_like(over, -1)
    expand.launch_gather_win(table, idx, n_win, bare, over_b)
    torch.cuda.synchronize()
    same = torch.equal(got, want) and torch.equal(got, lib) and torch.equal(got, bare)
    if not same or int(over) or int(over_p) or int(over_b):
        raise RuntimeError(f"K8 {case['name']} {case['direction']}: kernel, bare launch, plain "
                           f"and unwindowed gather differ at n_win {case['n_win']} (counts "
                           f"{int(over)}, {int(over_b)}, {int(over_p)})")
    return got


def in_turns(fns, iters: int):
    """Mean of each named timing, taken in the order given and then reversed;
    each value is (fn, hide_host)."""
    order = list(fns) + list(reversed(fns))
    got = {k: [] for k in fns}
    for k in order:
        fn, hide = fns[k]
        got[k].append(cuda_ms(fn, iters, hide_host=hide))
    return {k: sum(v) / len(v) for k, v in got.items()}


@functools.lru_cache(maxsize=None)
def _l2_flush(dev: torch.device) -> torch.Tensor:
    """192 MB to read between launches: almost four times the H100's 50 MB L2."""
    return torch.ones(96 << 20, dtype=torch.float16, device=dev)


def cold_ms(fn, iters: int, dev: torch.device) -> float:
    """Mean device time of one ``fn()`` that finds nothing in L2: before each
    call the stream reads :func:`_l2_flush` (192 MB, 57 us at 3.35 TB/s,
    long enough to cover the host's enqueue of the call), then CUDA events
    time the call alone."""
    flush = _l2_flush(dev)
    fn()
    events = []
    for _ in range(iters):
        flush.sum()
        pair = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        pair[0].record()
        fn()
        pair[1].record()
        events.append(pair)
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / iters


def time_case(case, iters: int = 20, before=None):
    """ms of the case: ``wrapper``, ``alone`` (bare launch, host hidden),
    ``plain``, ``index_select``, after the timings of ``before`` (name -> (fn,
    hide_host)), all in turns; then ``cold`` (the bare launch with L2 emptied
    before each, :func:`cold_ms`); plus ``bound`` (:func:`bound_bytes` / 3.35
    TB/s)."""
    table, idx, n_win = case["table"], case["idx"], case["n_win"]
    out = torch.empty(idx.numel(), table.shape[1], dtype=table.dtype, device=table.device)
    over = torch.empty((), dtype=torch.int32, device=table.device)
    idx64 = idx.long()
    alone = lambda: expand.launch_gather_win(table, idx, n_win, out, over)  # noqa: E731
    fns = {**(before or {}),
           "wrapper": (lambda: expand.gather_rows_windowed(table, idx, n_win), False),
           "alone": (alone, True),
           "plain": (lambda: expand.gather_rows_windowed_plain(table, idx, n_win), False),
           "index_select": (lambda: torch.index_select(table, 0, idx64), False)}
    ms = in_turns(fns, iters)
    ms["cold"] = cold_ms(alone, iters, table.device)
    ms["bound"] = bound_bytes(case) / PEAK_BYTES * 1e3
    return ms


def describe(case) -> str:
    t = case["table"]
    row = t.shape[1] * t.element_size()
    return (f"{case['name']} {case['direction']}: table ({t.shape[0]}, {t.shape[1]}) bf16 "
            f"({row}-byte rows, {t.numel() * t.element_size() / 1e6:.1f} MB), idx "
            f"({case['idx'].numel()},), n_win {case['n_win']}")

