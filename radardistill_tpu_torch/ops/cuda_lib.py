"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for ``sm_90a`` (one compiler process per
source, run in parallel) into one shared library with a plain C interface,
loaded with ``ctypes``. The build happens at first
use, into ``build/radardistill_tpu_torch/`` at the repository root, and is
redone when a source is newer than the library. Nothing here runs at import
time, so the CPU tests import every module without a CUDA toolchain.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("expand.cu", "dcn_sample.cu", "dcn_offset_grad.cu", "dcn_input_grad.cu",
           "conv_block.cu", "conv_block_fp.cu", "gather_win.cu", "conv_probe.cu", "mma_rate.cu",
           "conv3x3_wgmma.cu", "nms_bev.cu")
# included by the conv, probe and DCN sources
HEADERS = ("conv_tile.cuh", "wgmma_ops.cuh", "tma_ops.cuh", "dcn_geom.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "radardistill_tpu_torch"
LIB_PATH = BUILD_DIR / "librdt_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib = None


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def build(ptxas_verbose: bool = False) -> str:
    """Compile the kernels if the library is missing or stale: one ``nvcc -c``
    per source, all started together, then one link.

    Returns the compilers' diagnostics (``-Xptxas -v`` register and shared
    memory report when asked for), or "" when the library was up to date."""
    srcs = [CSRC / s for s in SOURCES]
    newest = max(s.stat().st_mtime for s in srcs + [CSRC / h for h in HEADERS])
    if LIB_PATH.exists() and LIB_PATH.stat().st_mtime >= newest and not ptxas_verbose:
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in srcs]
    extra = ("-Xptxas", "-v") if ptxas_verbose else ()
    procs = [subprocess.Popen([nvcc(), *NVCC_FLAGS, *extra, "-c", str(s), "-o", str(o)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for s, o in zip(srcs, objs)]
    logs = [p.communicate()[1] for p in procs]
    try:
        for s, p, log in zip(srcs, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s.name}:\n{log}")
        tmp = LIB_PATH.with_name(f"{LIB_PATH.stem}.{tag}.so")
        res = subprocess.run([nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed to link {LIB_PATH.name}:\n{res.stderr}")
        os.replace(tmp, LIB_PATH)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    return "".join(logs)


_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# the argument types of each entry point; every one returns an int32 error
# code, but ``rdt_error_string``
SIGNATURES = {
    "rdt_error_string": [_I32],
    "rdt_expand_rows": [_P, _P, _P, _I64, _I64, _I64, _I32, _P],
    "rdt_dcn_sample": [_P, _P, _P, _P, *([_I32] * 10), ctypes.c_float, _I32, _P],
    "rdt_dcn_offset_grad": [_P] * 6 + [_I32] * 10 + [ctypes.c_float, _I32, _P],
    "rdt_dcn_input_grad": [_P] * 4 + [_I32] * 10 + [ctypes.c_float, _I32, _P],
    "rdt_dcn_input_grad_tile": [_P] * 5 + [_I32] * 9 + [ctypes.c_float] + [_I32] * 5 + [_P],
    "rdt_conv_block": [_P] * 6 + [_I32] * 12 + [_P],
    "rdt_chain_conv": [_P] * 6 + [_I32] * 8 + [_P],
    "rdt_conv_block_fp": [_P] * 6 + [_I32] * 10 + [_P],
    "rdt_gather_rows_windowed": [_P] * 5 + [_I64, _I64, _I64, _I32, _I64, _I32, _P],
    "rdt_conv_probe": [_P] * 4 + [_I32] * 8 + [_P],
    "rdt_conv3x3_wgmma": [_P] * 4 + [_I32] * 11 + [_P],
    "rdt_conv_block_wgmma": [_P] * 7 + [_I32] * 10 + [_P],
    "rdt_chain_conv_wgmma": [_P] * 7 + [_I32] * 9 + [_P],
    "rdt_conv_block_fp_wgmma": [_P] * 6 + [_I32] * 8 + [_P],
    "rdt_mma_rate_bn": [_I32] * 4,
    "rdt_nms_bev_mask": [_P, _P, _P, _I32, _I32, ctypes.c_float, _P, _I32, _P],
    "rdt_nms_bev_scan": [_P, _P, _P, _I32, _I32, _I32, _P, _P, _I32, _P],
    "rdt_mma_rate": [_P, _P, _P, _I32, _I32, _I32, ctypes.c_longlong, ctypes.c_longlong,
                     *([_I32] * 5), _P],
}


def bind(so: ctypes.CDLL, names=SIGNATURES) -> ctypes.CDLL:
    """Set the C signatures of the entry points ``names`` on ``so``: the
    library ``lib()`` loads (all of them), or another build of some of its
    sources (those it holds)."""
    for name in names:
        fn = getattr(so, name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_char_p if name == "rdt_error_string" else _I32
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            _lib = bind(ctypes.CDLL(str(LIB_PATH)))
        return _lib


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if rc != 0:
        msg = lib().rdt_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc}: {msg}")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
