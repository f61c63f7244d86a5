"""Device ms a frame of the kernels launched inside the radar forward's spans
(``radar_vfe``, ``radar_backbone_3d``, ``radar_cma``, ``radar_neck``,
``radar_dense_head``)."""

SPANS = ("radar_vfe", "radar_backbone_3d", "radar_cma", "radar_neck", "radar_dense_head")


def read(view):
    us = view.kernel_us_launched_in(view.spans_named(*SPANS), view.main_thread)
    return None if not us else us / 1e3 / view.units
