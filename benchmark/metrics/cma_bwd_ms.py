"""Device ms a step of the kernels launched inside the program's
``radar_cma.backward`` span, on autograd's thread: the CMA's backward (K3, K4
and the rest of the DCN's)."""

from benchmark.lib.program_spans import kernel_us_in


def read(view):
    us = kernel_us_in(view, "radar_cma.backward")
    return None if us is None else us / 1e3 / view.calls
