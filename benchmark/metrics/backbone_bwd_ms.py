"""Device ms a step of the kernels launched inside the program's
``radar_vfe.backward`` and ``radar_backbone_3d.backward`` spans, on
autograd's thread: the student's VFE and 3D backbone's backward."""

from benchmark.lib.program_spans import kernel_us_in


def read(view):
    us = kernel_us_in(view, "radar_vfe.backward", "radar_backbone_3d.backward")
    return None if us is None else us / 1e3 / view.calls
