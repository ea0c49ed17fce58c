"""Spans around the harness's calls into the program, and the reduction of
a ``torch.profiler`` trace of the traced window to what the per-layer
metrics read.

The harness opens a span (``torch.profiler.record_function``) around each
call it makes into the program: ``upload``, ``replay``, ``readback``,
``wait`` and ``check`` when serving, ``mixup``, ``step`` and
``loss_read`` when training, and ``window`` around the whole traced
window. Device operations (kernels, copies, sets) come from the
profiler's CUDA activity on the same clock. Spans are recorded only in a
traced run; otherwise a span costs one branch.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import time

WINDOW = "window"


class Spans:
    """Host spans of the harness, recorded only when ``enabled``."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.records: list = []  # (name, start_ns, end_ns), perf_counter clock

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.enabled:
            yield
            return
        import torch

        t0 = time.perf_counter_ns()
        with torch.profiler.record_function(name):
            yield
        self.records.append((name, t0, time.perf_counter_ns()))


@dataclasses.dataclass
class TraceView:
    """What the per-layer metrics read from one traced window: its
    length, the device's busy time, the device operations inside it, the
    units of work it completed (forwards, requests or steps) and the
    images those held, and the cell they ran in."""

    window_s: float
    busy_s: float
    device_ops: list  # (name, seconds, kind): kind is "kernel", "memcpy" or "memset"
    kernel_launches: int  # kernels (not copies or sets) that ran inside the window
    units: int
    images: int
    cell: object
    breakdown: dict

    def kernels(self) -> list:
        return [(name, s) for name, s, kind in self.device_ops if kind == "kernel"]


def _kind(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def _union(intervals: list) -> list:
    merged: list = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce_trace(events, span_names, units: int, images: int, cell, top: int = 10) -> TraceView:
    """Reduce profiler ``events`` (``prof.events()``: objects with
    ``name``, ``device_type`` and ``time_range`` in microseconds) to a
    ``TraceView`` of the ``window`` span's interval."""
    from torch.autograd import DeviceType

    names = set(span_names) | {WINDOW}
    host, device = [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.name in names or getattr(e, "is_user_annotation", False):
                continue
            device.append((start, end, e.name))
        elif e.name in names:
            host.append((start, end, e.name))
    windows = [(s, e) for s, e, n in host if n == WINDOW]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} window spans, not one")
    w0, w1 = windows[0]
    inside = [(max(s, w0), min(e, w1), n) for s, e, n in device if e > w0 and s < w1]
    busy = _union([(s, e) for s, e, _ in inside])
    busy_us = sum(e - s for s, e in busy)
    ops: dict = {}
    for s, e, n in inside:
        ops[n] = ops.get(n, 0.0) + (e - s) / 1e6
    # the device's idle gaps inside the window, by the innermost harness
    # span the host was in when each gap began
    # (the harness's spans do not nest, so the last one begun is the one)
    spans = sorted((s, e, n) for s, e, n in host if n != WINDOW)
    starts = [s for s, _, _ in spans]
    gaps: dict = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        i = bisect.bisect_right(starts, g0) - 1
        where = spans[i][2] if i >= 0 and spans[i][1] > g0 else "other"
        gaps[where] = gaps.get(where, 0.0) + (g1 - g0) / 1e6
    breakdown = {
        "device_ops": sorted(([n[:200], t] for n, t in ops.items()), key=lambda x: -x[1])[:top],
        "idle_gaps": sorted(([n, t] for n, t in gaps.items()), key=lambda x: -x[1])[:top],
    }
    return TraceView(
        window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6,
        device_ops=[(n, t, _kind(n)) for n, t in ops.items()],
        kernel_launches=sum(1 for _, _, n in inside if _kind(n) == "kernel"),
        units=units, images=images, cell=cell, breakdown=breakdown,
    )


def write_summary(view: TraceView, spans: Spans, name: str) -> str:
    """Write the traced window's spans and the profiler's summary to a
    file under ``TMPDIR``; returns its path."""
    import tempfile

    path = os.path.join(tempfile.gettempdir(), f"benchmark_trace_{name}.json")
    summary = {
        "window_s": view.window_s, "busy_s": view.busy_s, "units": view.units, "images": view.images,
        "device_ops": sorted(([n, t, k] for n, t, k in view.device_ops), key=lambda x: -x[1]),
        "breakdown": view.breakdown,
        "spans": [[n, s / 1e9, e / 1e9] for n, s, e in spans.records],
    }
    with open(path, "w") as f:
        json.dump(summary, f)
    return path
