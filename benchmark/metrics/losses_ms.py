"""Device ms a step of the kernels launched inside the ``assign_targets`` and
``losses`` spans (the targets and the head and distillation losses' forward)
on the step's thread; None for a program without the ``losses`` span."""


def read(view):
    if "losses" not in view.spans:
        return None
    us = view.kernel_us_launched_in(view.spans_named("assign_targets", "losses"),
                                    view.main_thread)
    return None if us is None else us / 1e3 / view.calls
