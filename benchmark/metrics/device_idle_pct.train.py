"""Share of the traced train steps' wall time in which no kernel or copy ran
on the card: 100 - the union of their device intervals over the window."""


def read(view):
    if not view.kernels or view.window_us <= 0:
        return None
    return 100.0 * (1.0 - view.busy_us / view.window_us)
