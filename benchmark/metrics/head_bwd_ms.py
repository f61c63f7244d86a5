"""Device ms a step of the kernels launched inside the program's
``losses.backward``, ``radar_dense_head.backward`` and
``radar_neck.backward`` spans, on autograd's thread: the losses', the head's
and the neck's backward."""

from benchmark.lib.program_spans import kernel_us_in


def read(view):
    us = kernel_us_in(view, "losses.backward", "radar_dense_head.backward",
                      "radar_neck.backward")
    return None if us is None else us / 1e3 / view.calls
