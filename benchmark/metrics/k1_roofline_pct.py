"""K1's share of its roofline: its bound a step (the larger of its counted
bytes over 3.35 TB/s and its int8 operations over 1979 TOP/s, by the frozen
formula ``conv_block_work`` on the reference's first step) over the device
time of K1's kernels a step."""

import re

from benchmark.lib.trace import PEAK_BYTES, PEAK_INT8

# K1 (``ops/conv_block.py::conv_block``) on its ``wgmma`` route launches the
# int8 instantiations of two templates of ``csrc/conv3x3_wgmma.cu`` with its
# own epilogues, ``EPI_K1_S8`` (2) and ``EPI_K1_BF16`` (3); K6, K7, K9 and P1
# instantiate the same templates with other epilogues. Its resident
# ``mma.sync`` route is ``conv_block_kernel`` (K1's alone). Its streamed
# variant shares ``conv_stream_kernel`` with K7's streamed route, so a window
# that holds that kernel cannot be attributed: the reader returns nothing.
WGMMA = ("conv_wgmma_kernel<", "conv_co64_kernel<")
K1_EPILOGUES = {"2", "3", "EPI_K1_S8", "EPI_K1_BF16"}
RESIDENT = "conv_block_kernel<"
SHARED = "conv_stream_kernel<"
_MANGLED_EPI = re.compile(r"(?:conv_wgmma_kernel|conv_co64_kernel)I.*?EpiE(\d+)E")


def is_k1(name: str) -> bool:
    """Whether a kernel's name, as the profiler gives it (demangled or not),
    is one of K1's."""
    if RESIDENT in name or "conv_block_kernelIL" in name:
        return True
    m = _MANGLED_EPI.search(name)
    if m:
        return m.group(1) in K1_EPILOGUES
    for t in WGMMA:
        i = name.find(t)
        if i >= 0:
            args = name[i + len(t):name.find(">", i)].split(",")
            last = re.search(r"(\w+)\W*$", args[-1])
            return len(args) == 2 and "S8" in args[0] and bool(last) and \
                last.group(1) in K1_EPILOGUES
    return False


def read(view):
    work = view.cell.get("work")
    if not work or not work.get("k1_ops"):
        return None
    if any(SHARED in k.name or "conv_stream_kernelIL" in k.name for k in view.kernels):
        return None
    us = sum(k.end - k.start for k in view.kernels if is_k1(k.name))
    if not us:
        return None
    bound_s = max(work["k1_ops"] / PEAK_INT8, work["k1_bytes"] / PEAK_BYTES)
    return 100.0 * bound_s * view.units / (us / 1e6)
