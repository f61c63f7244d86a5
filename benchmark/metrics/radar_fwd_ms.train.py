"""Device ms a step of the kernels launched inside the student's and the
CMA's forward spans (``radar_vfe``, ``radar_backbone_3d``, ``radar_cma``,
``radar_neck``, ``radar_dense_head``) on the step's thread."""

SPANS = ("radar_vfe", "radar_backbone_3d", "radar_cma", "radar_neck", "radar_dense_head")


def read(view):
    us = view.kernel_us_launched_in(view.spans_named(*SPANS), view.main_thread)
    return None if not us else us / 1e3 / view.calls
