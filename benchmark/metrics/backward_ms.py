"""Device ms a step of the kernels launched from the autograd engine's thread
(any thread but the one that runs the step)."""


def read(view):
    us = sum(k.end - k.start for k in view.kernels
             if k.thread is not None and k.thread != view.main_thread)
    return None if not us else us / 1e3 / view.calls
