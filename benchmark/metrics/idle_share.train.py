"""The device's idle share of the traced window: 1 − the union of its
operations' intervals (kernels, copies, sets) over the window, in %."""


def read(view):
    if view.window_s <= 0 or view.busy_s <= 0:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)
