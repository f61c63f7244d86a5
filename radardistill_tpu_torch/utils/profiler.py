"""Profiling hooks: a trace of a block of work, the program's spans, and the
cost count of one call.

Counterpart of ``radardistill_tpu/utils/profiler.py``: ``trace(logdir)``
records the enclosed block with ``torch.profiler`` (CPU and, where there is
one, CUDA activity) and writes it as a Chrome trace
(``trace_<pid>.json``, which TensorBoard's profiler plugin and
``chrome://tracing`` read); ``cost_analysis(fn, *args)`` counts the
floating-point operations and the bytes of one call of ``fn``, as the JAX
module's function of that name reads them from XLA's cost model
(``tools/torch_test.py --cal_params`` prints them).

The program's spans are ``torch.profiler`` user annotations, so host spans and
kernels share the trace's one clock. :func:`span` opens one only while a
profiler runs (else it costs one flag read). :func:`mark_backward` gives a
stage's backward a span ``<stage>.backward``: while a profiler runs, the
forward puts a gradient hook on the stage's outputs (the graph itself is left
as it is); the hook, which runs when the first of their gradients is
computed, closes the span open in that backward pass and opens the stage's,
and the pass's end closes the last one. The spans of one pass tile its
backward on autograd's thread. A child span is named ``<parent>.<step>``.

The count runs the call once under a ``TorchDispatchMode`` and counts every
aten op it runs (the backward's too, if the call runs one) by XLA's
``HloCostAnalysis`` rules, each established by compiling the single lax op and
reading its ``cost_analysis()``:

- a matmul or a convolution: 2 flops per multiply-add of real operands;
  taps on padding, on the holes of a transposed convolution's
  ``lhs_dilation`` and skipped by a stride count nothing; groups are counted;
- elementwise arithmetic, compares, selects and dtype conversions: 1 a result
  element; transcendentals (``exp``, ``rsqrt``, ``sin``, ...) 0; an op that
  stands for several lax ops counts them (``sigmoid`` 3 as XLA expands
  ``logistic``, ``where`` of a compare 1 + 1, ``remainder`` as
  ``jnp.remainder``, ``F.batch_norm`` in eval as flax's four ops);
- a reduction: (input elements - output elements) x the reducer's flops
  (``argmax`` and ``max(dim)``: 9, the variadic reducer's);
  ``cumsum`` / ``cummax`` as XLA's reduce-window rewrite of that length;
  ``sort`` N x ceil(log2 N) of the whole operand; ``topk`` 0 (a custom call);
- data movement (views, copies, ``cat``, fills, ``empty``): 0; indexing,
  gathers and scatters count the index arithmetic jnp's indexing adds (3 an
  index element, 7 for ``gather`` as ``jnp.take_along_axis``), and a scatter
  that adds or takes a max 1 an update.

Every hand-written kernel's dispatcher is wrapped by :func:`counted`: inside
the count it adds the kernel's own formula (the flops and bytes of its module's
``*_work`` function, the figures PERF.md's bound divides) and does not count
the aten ops it runs, its plain version's on the CPU nor the wrapper's
allocations and copies on the card. So a call counts the same whichever route
runs it. Outside a count the wrapper costs one attribute read.

Bytes are what the port moves: for every aten op that is not a view or an
allocation, its tensor operands' and results' bytes; for a kernel, its
formula. XLA's ``bytes accessed`` is after fusion, so the eager port reads
more; the two are printed side by side, not matched.
"""

from __future__ import annotations

import contextlib
import functools
import math
import os
from collections import Counter
from pathlib import Path

import numpy as np
import torch
from torch.autograd.graph import register_multi_grad_hook
from torch.profiler import record_function
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack


@contextlib.contextmanager
def trace(logdir: str):
    """Trace the enclosed block into ``logdir/trace_<pid>.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities, record_shapes=False) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(Path(logdir) / f"trace_{os.getpid()}.json"))


_NULL_SPAN = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def span(name: str):
    """``record_function(name)`` while a profiler runs, else a shared null
    context."""
    return record_function(name) if _profiling() else _NULL_SPAN


# the ``<stage>.backward`` span open in each running backward pass, by the
# pass's graph task id
_open_backward = {}


def _close_backward(task: int) -> None:
    rf = _open_backward.pop(task, None)
    if rf is not None:
        rf.__exit__(None, None, None)


def _open_stage_backward(name: str) -> None:
    """Open the span ``name`` in place of the one open in the running backward
    pass."""
    task = torch._C._current_graph_task_id()
    if task in _open_backward:
        _close_backward(task)
    else:  # the pass's first stage: its end closes the last span
        torch.autograd.Variable._execution_engine.queue_callback(
            functools.partial(_close_backward, task))
    rf = record_function(name)
    rf.__enter__()
    _open_backward[task] = rf


def mark_backward(name: str, outputs) -> None:
    """While a profiler runs and gradients are taken, hook ``outputs`` (a
    tensor, or a tuple, list or dict of them) so that the first of their
    gradients computed in a backward pass opens the span ``name``
    (:func:`_open_stage_backward`); otherwise do nothing."""
    if not (_profiling() and torch.is_grad_enabled()):
        return
    if isinstance(outputs, torch.Tensor):
        outputs = (outputs,)
    elif isinstance(outputs, dict):
        outputs = outputs.values()
    grad = [t for t in outputs if isinstance(t, torch.Tensor) and t.requires_grad]
    if grad:
        register_multi_grad_hook(grad, lambda _: _open_stage_backward(name), mode="any")


# ---------------------------------------------------------------- the rules

# 1 flop a result element (XLA counts each elementwise HLO once)
_ONE = frozenset("""
add sub rsub mul div true_divide neg abs sign sgn floor ceil round trunc frac reciprocal
maximum minimum fmax fmin max_other min_other clamp clamp_min clamp_max clip relu threshold
eq ne lt le gt ge equal greater less greater_equal less_equal not_equal
logical_and logical_or logical_xor logical_not bitwise_and bitwise_or bitwise_xor bitwise_not
bitwise_left_shift bitwise_right_shift __and__ __or__ __xor__ __lshift__ __rshift__
isnan isfinite isposinf isneginf signbit square fmod masked_fill where heaviside copysign
hardtanh
""".split())
# transcendentals: XLA counts them apart, as no flops
_TRANSCENDENTAL = frozenset("""
exp exp2 expm1 log log2 log10 log1p sqrt rsqrt sin cos tan asin acos atan atan2 sinh cosh
tanh asinh acosh atanh erf erfc erfinv lgamma digamma
""".split())
# several lax ops a result element (counted on the CPU's compiled HLO)
_SEVERAL = {"sigmoid": 3, "isinf": 2, "hypot": 15, "addcmul": 2, "addcdiv": 2, "lerp": 3,
            "leaky_relu": 3, "nan_to_num": 6}
# dtype-dependent: float, integer
_BY_DTYPE = {"remainder": (8, 10), "floor_divide": (11, 9)}
# reductions: one operation an element folded (``max``, ``min`` without a dim
# too); the arg reductions and ``max``/``min`` over a dim (values and
# indices) 9, the variadic reducer's; the rest as their lax ops
_REDUCE = frozenset("sum mean amax amin prod any all max min".split())
_ARG_REDUCE = {"argmax", "argmin"}
_OTHER_REDUCE = {"var", "std", "var_mean", "std_mean", "norm", "linalg_vector_norm", "nansum",
                 "count_nonzero", "logsumexp"}
_VARIADIC = 9  # flops of jnp.argmax's reducer per element folded
_SCAN = {"cumsum": 1, "cumprod": 1, "cummax": 1, "cummin": 1, "logcumsumexp": 1}
# indexing: flops a (non-boolean) index element, as jnp's indexing normalizes
# negative indices (lt, add, select); jnp.take_along_axis 7; and the position
# of the index operand
_INDEXED = {"index": (3, 1), "index_select": (3, 2), "index_put": (3, 1), "gather": (7, 2),
            "scatter": (3, 2), "scatter_add": (3, 2), "scatter_reduce": (3, 2),
            "index_add": (3, 2), "index_reduce": (3, 2), "index_fill": (3, 2),
            "index_copy": (3, 2)}
_BN = frozenset({"native_batch_norm", "_native_batch_norm_legit_no_training",
                 "_native_batch_norm_legit", "cudnn_batch_norm", "miopen_batch_norm",
                 "_batch_norm_no_update", "_batch_norm_with_update"})
# allocations: no bytes moved
_ALLOC = frozenset("""
empty empty_like empty_strided new_empty new_empty_strided empty_permuted
_local_scalar_dense lift_fresh set_ resize_ record_stream
""".split())


def _numel(t) -> int:
    return t.numel() if isinstance(t, torch.Tensor) else 0


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def scan_flops(length: int) -> int:
    """Flops of one running reduction (``cumsum``) over ``length`` elements as
    XLA's CPU compile counts it: a reduce-window up to 16, above that its
    rewrite into blocks of 16 and a scan of the block totals."""
    if length <= 16:
        return length * (length - 1)
    nb = -(-length // 16)
    return nb * 240 + scan_flops(nb) + 16 * nb + (nb - 1 if nb <= 16 else 0)


def sort_flops(n: int) -> int:
    """XLA's count of a sort of an operand of ``n`` elements, any batch."""
    return n * max(math.ceil(math.log2(n)), 0) if n > 1 else 0


def real_taps(n_in: int, n_out: int, k: int, stride: int = 1, pad_lo: int = 0,
              dilation: int = 1, lhs_dilation: int = 1) -> int:
    """(output position, tap) pairs of one spatial dimension whose input
    coordinate falls on a real element: not on padding, not on a hole of the
    ``lhs_dilation``, as XLA's convolution count has it."""
    o = np.arange(n_out, dtype=np.int64)[:, None]
    t = np.arange(k, dtype=np.int64)[None, :]
    p = o * stride + t * dilation - pad_lo
    ok = (p >= 0) & (p <= (n_in - 1) * lhs_dilation) & (p % lhs_dilation == 0)
    return int(ok.sum())


def conv_macs(x_shape, w_shape, out_shape, stride, padding, dilation, transposed, groups):
    """Multiply-adds of real operands of an ``aten.convolution`` (NCHW shapes,
    its weight layout)."""
    spatial = len(x_shape) - 2
    if transposed:
        cin, cout = w_shape[0], w_shape[1] * groups
    else:
        cout, cin = w_shape[0], w_shape[1] * groups
    taps = 1
    for d in range(spatial):
        k, n_in, n_out = w_shape[2 + d], x_shape[2 + d], out_shape[2 + d]
        s, p, dl = stride[d], padding[d], dilation[d]
        if transposed:
            taps *= real_taps(n_in, n_out, k, 1, dl * (k - 1) - p, dl, s)
        else:
            taps *= real_taps(n_in, n_out, k, s, p, dl)
    return x_shape[0] * (cin // groups) * cout * taps


def _dims(dim, ndim):
    if dim is None or (isinstance(dim, (list, tuple)) and len(dim) == 0):
        return list(range(ndim))
    if isinstance(dim, int):
        dim = [dim]
    return [d % max(ndim, 1) for d in dim]


def op_flops(func, args, kwargs, out) -> tuple:
    """(kind, flops) of one aten op by the rules of the module docstring;
    kind is ``conv``, ``matmul`` or ``elementwise``."""
    name = func.overloadpacket.__name__
    if name.endswith("_") and not name.startswith("_"):
        name = name[:-1]
    first = out[0] if isinstance(out, (list, tuple)) and out else out
    n_out = _numel(first)
    if name == "convolution":
        x, w, bias = args[0], args[1], args[2]
        macs = conv_macs(x.shape, w.shape, first.shape, *args[3:6], args[6], args[8])
        return "conv", 2 * macs + (n_out if bias is not None else 0)
    if name == "convolution_backward":
        grad, x, w = args[0], args[1], args[2]
        macs = conv_macs(x.shape, w.shape, grad.shape, *args[4:7], args[7], args[9])
        mask = args[10]
        flops = 2 * macs * (int(mask[0]) + int(mask[1]))
        if mask[2]:
            flops += grad.numel() - grad.shape[1]
        return "conv", flops
    if name in ("mm", "bmm", "addmm", "baddbmm", "addbmm", "dot", "vdot", "mv", "addmv"):
        a, b = (args[1], args[2]) if name.startswith("add") or name == "baddbmm" else args[:2]
        k = a.shape[-1]
        flops = 2 * n_out * k * (a.shape[0] if name == "addbmm" else 1)
        if name.startswith("add") or name == "baddbmm":
            flops += n_out * (1 + (kwargs.get("beta", 1) != 1) + (kwargs.get("alpha", 1) != 1))
        return "matmul", flops
    if name in _BN:
        x = args[0]
        c = x.shape[1] if x.dim() > 1 else x.numel()
        return "elementwise", 3 * x.numel() + 2 * c
    if name in _TRANSCENDENTAL:
        return "elementwise", 0
    if name in ("pow", "float_power"):
        e = args[1] if len(args) > 1 else kwargs.get("exponent")
        if isinstance(e, (int, float)) and not isinstance(e, bool) and float(e).is_integer():
            return "elementwise", n_out * max(int(abs(e)).bit_length() - 1
                                              + bin(int(abs(e))).count("1") - 1, 0)
        return "elementwise", 0
    if name in ("_to_copy", "copy"):
        src = args[1] if name == "copy" else args[0]
        dst_dtype = first.dtype if name == "_to_copy" else args[0].dtype
        return "elementwise", n_out if src.dtype != dst_dtype else 0
    if name in _ONE:
        return "elementwise", n_out
    if name in _SEVERAL:
        return "elementwise", _SEVERAL[name] * n_out
    if name in _BY_DTYPE:
        fl, it = _BY_DTYPE[name]
        return "elementwise", n_out * (fl if first.is_floating_point() else it)
    if name in ("softmax", "_softmax", "log_softmax", "_log_softmax"):
        x = args[0]
        rows = x.numel() // max(x.shape[args[1]] if x.dim() else 1, 1)
        return "elementwise", 2 * (x.numel() - rows) + (3 if "log" in name else 2) * x.numel()
    if name in _REDUCE or name in _ARG_REDUCE or name in _OTHER_REDUCE:
        x = args[0]
        if not isinstance(x, torch.Tensor):
            return "elementwise", 0
        if name in ("max", "min") and len(args) > 1 and isinstance(args[1], torch.Tensor):
            return "elementwise", n_out  # the elementwise maximum
        dim = args[1] if len(args) > 1 else kwargs.get("dim")
        folded = x.numel() - n_out
        if name in _ARG_REDUCE or (name in ("max", "min") and dim is not None):
            return "elementwise", _VARIADIC * folded
        if name in ("var", "std", "var_mean", "std_mean"):
            return "elementwise", 4 * x.numel()
        if name in ("norm", "linalg_vector_norm", "nansum", "count_nonzero"):
            # the square (the isnan and select, the compare and cast) first
            return "elementwise", (2 if name in ("nansum", "count_nonzero") else 1) * x.numel() + folded
        if name == "logsumexp":
            return "elementwise", 2 * folded + x.numel() + 4 * n_out
        return "elementwise", folded + (n_out if name == "mean" else 0)
    if name in _SCAN:
        x = args[0]
        length = x.shape[args[1]] if x.dim() else 1
        return "elementwise", (x.numel() // max(length, 1)) * scan_flops(length)
    if name == "sort":
        return "elementwise", sort_flops(args[0].numel())
    if name in _INDEXED:
        per, pos = _INDEXED[name]
        idx = args[pos] if len(args) > pos else kwargs.get("index", kwargs.get("indices"))
        flops = per * sum(t.numel() for t in _tensors(idx)
                          if not (t.is_floating_point() or t.dtype == torch.bool))
        if name in ("scatter_add", "index_add", "scatter_reduce", "index_reduce") or (
                name == "index_put" and (args[3] if len(args) > 3
                                         else kwargs.get("accumulate", False))):
            flops += _numel(args[3] if name != "index_put" else args[2])
        return "elementwise", flops
    return "elementwise", 0


# --------------------------------------------------------------- the count


class _Count:
    """Live counts (one per active ``cost_analysis``); ``active`` is the number
    of counts open in the process, the wrappers' one attribute read."""

    active = 0


class _CostMode(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flops = Counter()
        self.bytes = 0
        self.op_flops = Counter()  # by aten op name
        self.op_bytes = Counter()
        self.kernels = Counter()
        self.kernel_flops = Counter()
        self.kernel_bytes = Counter()
        self.inside = 0  # depth of kernel dispatchers being run

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.inside:
            name = func.overloadpacket.__name__
            kind, flops = op_flops(func, args, kwargs, out)
            nbytes = 0 if func.is_view or name in _ALLOC else (
                _bytes(args) + _bytes(kwargs) + _bytes(out))
            self.flops[kind] += flops
            self.bytes += nbytes
            self.op_flops[name] += flops
            self.op_bytes[name] += nbytes
        return out


def _live_count():
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, _CostMode):
            return mode
    return None


def count_kernel(name: str, flops: float, nbytes: float) -> None:
    """Add one call of the hand-written kernel ``name`` to the count open on
    this thread, if any: its formula's flops and bytes."""
    mode = _live_count() if _Count.active else None
    if mode is not None:
        mode.kernels[name] += 1
        mode.kernel_flops[name] += flops
        mode.kernel_bytes[name] += nbytes


def counted(name: str, work):
    """Wrap a kernel's dispatcher: inside a count, one call adds ``work(*args,
    **kwargs) -> (flops, bytes)`` under ``name`` (:func:`count_kernel`) and the
    aten ops that the call and its formula run are not counted (nor a kernel
    dispatcher it calls); outside, the dispatcher runs as it is."""

    def wrap(fn):
        @functools.wraps(fn)
        def dispatcher(*args, **kwargs):
            if not _Count.active:
                return fn(*args, **kwargs)
            mode = _live_count()
            if mode is None or mode.inside:
                return fn(*args, **kwargs)
            mode.inside += 1
            try:
                count_kernel(name, *work(*args, **kwargs))
                return fn(*args, **kwargs)
            finally:
                mode.inside -= 1

        return dispatcher

    return wrap


def cost_analysis(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once, where its arguments live, and count
    its work (see the module docstring). Returns ``{"flops",
    "bytes_accessed"}`` as the JAX function does, and beside them ``split``
    (flops of ``conv``, ``matmul``, ``elementwise`` and ``kernels``),
    ``kernels`` (calls per kernel), ``kernel_flops``, ``kernel_bytes``,
    ``op_flops`` and ``op_bytes`` (per aten op name, the kernels' own ops
    left out) and ``out``, what the call returned."""
    mode = _CostMode()
    _Count.active += 1
    try:
        with mode:
            out = fn(*args, **kwargs)
    finally:
        _Count.active -= 1
    kernel_flops = sum(mode.kernel_flops.values())
    split = {k: mode.flops.get(k, 0) for k in ("conv", "matmul", "elementwise")}
    split["kernels"] = kernel_flops
    return {"flops": float(sum(split.values())),
            "bytes_accessed": float(mode.bytes + sum(mode.kernel_bytes.values())),
            "split": split, "kernels": dict(mode.kernels),
            "kernel_flops": dict(mode.kernel_flops), "kernel_bytes": dict(mode.kernel_bytes),
            "op_flops": dict(mode.op_flops), "op_bytes": dict(mode.op_bytes), "out": out}
