"""The end-to-end statistics, each over the whole window. The window
runs from the first unit of work sent to the completion of the last one
sent before ``--seconds`` had passed, so it closes on a completion and
holds every unit whole: a rate is all its work over all its time, and a
percentile is over every request in it."""

from __future__ import annotations

import numpy as np


def rate(done: list, start: float, per_unit: int) -> float:
    """Items a second over the window that opened at ``start`` and closed
    at the last of the completion times ``done`` (units of ``per_unit``
    items each)."""
    return len(done) * per_unit / (max(done) - start)


def latency_ms(spans: list, q: float) -> float:
    """The ``q``-th percentile, in ms, of the requests ``(start, finish)``."""
    return float(np.percentile(np.array([(b - a) * 1e3 for a, b in spans]), q))
