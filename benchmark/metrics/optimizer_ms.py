"""Device ms a step of the kernels launched inside torch's own
``Optimizer.step#...`` span."""


def read(view):
    us = view.kernel_us_launched_in(view.spans_named("Optimizer.step#", prefix=True))
    return None if not us else us / 1e3 / view.calls
