"""The training step's share of the card's peaks: the least time the
published peaks allow a step over the measured step time, in %. The
forward's operations (``work/<family>.py``) count at the int8 peak, the
backward's (twice the forward's) at 67 TFLOP/s float32, since the
trainer's backward GEMMs run in float32 with TF32 off."""

from benchmark import peaks, spec


def read(view):
    if view.window_s <= 0 or view.units <= 0 or view.busy_s <= 0:
        return None
    ops = spec.load_module("work", view.cell.config["family"], view.cell.root).forward_ops(view.cell.model)
    least = view.images * (ops / peaks.INT8_OPS + 2 * ops / peaks.FP32_FLOPS)
    return 100.0 * least / view.window_s
