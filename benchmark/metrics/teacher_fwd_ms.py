"""Device ms a step of the kernels launched inside the frozen teacher's spans
(``vfe``, ``backbone_3d``, ``backbone_2d``) on the step's thread."""

SPANS = ("vfe", "backbone_3d", "backbone_2d")


def read(view):
    us = view.kernel_us_launched_in(view.spans_named(*SPANS), view.main_thread)
    return None if not us else us / 1e3 / view.calls
