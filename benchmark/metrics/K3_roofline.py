"""K3's share of its roofline: the summed least time of its launches in
the traced window (each the larger of its bytes over 3.35 TB/s and its
operations over 1,979 TOP/s, from ``work/K3.py``) over their summed
device time, in %. None where the window ran no K3."""

from benchmark import peaks, spec


def read(view):
    work = spec.load_module("work", "K3", view.cell.root)
    spent = sum(s for name, s in view.kernels() if work.NAME.search(name))
    if spent <= 0 or view.units <= 0:
        return None
    batch = view.images // view.units
    bound = sum(max(b / peaks.HBM_BYTES, o / peaks.INT8_OPS) for b, o in work.launches(view.cell.model, batch))
    return 100.0 * bound * view.units / spent
