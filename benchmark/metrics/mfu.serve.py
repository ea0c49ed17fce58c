"""The served forward's share of the card's int8 peak: the model's
operations an image (``work/<family>.py``) times the images completed in
the traced window, over its seconds and 1,979 TOP/s, in %."""

from benchmark import peaks, spec


def read(view):
    if view.window_s <= 0 or view.busy_s <= 0:
        return None
    ops = spec.load_module("work", view.cell.config["family"], view.cell.root).forward_ops(view.cell.model)
    return 100.0 * ops * view.images / view.window_s / peaks.INT8_OPS
