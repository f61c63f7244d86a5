"""Device ms a frame of the kernels launched inside the ``decode_and_nms``
span."""


def read(view):
    us = view.kernel_us_launched_in(view.spans_named("decode_and_nms"), view.main_thread)
    return None if not us else us / 1e3 / view.units
