"""Spans of the port's work, recorded while ``torch.profiler`` records.

A ``Span`` marks one stage of a forward or of a train step and is entered
with ``with``: ``engine.embed``, ``engine.attention``, ``engine.mlp``,
``engine.merge`` and ``engine.head`` in the serving engines
(``deploy/engine.py``, ``deploy/swin_engine.py``), ``train.forward``,
``train.backward`` and ``train.optimizer`` in the train step
(``train/steps.py``). The spans of one level tile their forward or step:
each kernel it launches is launched inside exactly one of them. A span
may lie inside another: the ViT engine's ``engine.attention_core`` (the
attention kernel or its plain chain) inside ``engine.attention``.

Tracing is on exactly while ``torch.profiler`` records: a span reads
``torch.autograd.profiler._is_profiler_enabled``, the flag the profiler
sets when it starts and clears when it stops. Off, a span costs the
``with`` statement, that read and a branch. On, it opens ``torch.profiler.record_function(name)``, so
it lies in the profiler's trace on the clock of the device activity, and
appends a ``Record``: its name, the span it lies in, its host start and
end (``time.perf_counter_ns``) and its device time, between a pair of
timing events on the current CUDA stream (none without CUDA, and none
while that stream is being captured). Nothing waits for the device when a
span is recorded: ``take`` and ``peek`` resolve the device times.

A CUDA-graph replay runs no Python, so a span inside a captured forward
records nothing when the graph replays. Under ``marking()`` a capture
records instead a timing event into the graph at each span's start and
end, and no host record (``Marks``). ``deploy/graphs.py:capture_infer``
captures such a marked graph beside the plain one; each replay of it
gives one sample, the device ms of each of its stages in order.

Kernel launches are counted by the kernel wrappers' ``launches``
attributes (``kernels.WRAPPERS``), not here. ``SETUP_S`` holds the
seconds of one-off set-up work, recorded whether tracing is on or not
(``setup_timer``; ``capture_infer`` records its own).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch
from torch.autograd import profiler as _profiler

SETUP_S: dict[str, float] = {}  # name -> seconds, summed over the calls


@dataclasses.dataclass
class Record:
    """One span as it ran: ``parent`` is the name of the span it lies in
    (None at the top); host times in ns on ``time.perf_counter_ns``'s
    clock; ``device_ms`` None where no timing events were recorded."""

    name: str
    parent: str | None
    start_ns: int
    end_ns: int | None = None
    device_ms: float | None = None
    events: tuple | None = None  # (start, end) timing events until resolved

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


@dataclasses.dataclass
class Trace:
    """What the recorder holds: the closed spans in the order they
    opened, and one sample a marked replay, ``((stage, device ms), ...)``
    in the order of the stages."""

    spans: list
    samples: list


class Marks:
    """The stages of a forward captured under ``marking()``: ``[name,
    start event, end event]`` in the order the spans opened, as the host
    records of an eager forward lie; ``last`` is the end event of the
    span that closed last."""

    def __init__(self):
        self.stages: list = []
        self.last = None
        self.replayed = False  # a replay whose sample is not read yet

    def ready(self) -> bool:
        """Whether the graph holds stages and its last replay has finished
        (``Event.query``, no wait)."""
        return bool(self.stages) and (not self.replayed or self.last.query())

    def replay(self, graph: torch.cuda.CUDAGraph) -> None:
        """Read the previous replay's stage times into the recorder, then
        replay ``graph``, the graph these marks were captured into. Call
        only when ``ready()``."""
        _read(self)
        graph.replay()
        self.replayed = True
        _replayed.append(self)


_spans: list[Record] = []
_samples: list[tuple] = []
_replayed: list[Marks] = []  # marks whose last replay's sample is not read yet
_open: list = []  # (span, record or None, record_function or marked stage) of each open span
_marks: Marks | None = None  # set inside marking()


class Span:
    """A named stage; ``with span:`` around its work. One instance serves
    every call (its state lives in the recorder), so a module makes its
    spans once."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _marks is None and not _profiler._is_profiler_enabled:
            return self
        if _marks is not None:
            start = torch.cuda.Event(enable_timing=True, external=True)
            start.record()
            stage = [self.name, start, None]
            _marks.stages.append(stage)
            _open.append((self, None, stage))
            return self
        parent = next((r.name for _, r, _ in reversed(_open) if r is not None), None)
        record = Record(self.name, parent, time.perf_counter_ns())
        _spans.append(record)
        fn = torch.profiler.record_function(self.name)
        fn.__enter__()
        if torch.cuda.is_initialized() and not torch.cuda.is_current_stream_capturing():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            record.events = (start,)
        _open.append((self, record, fn))
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if not _open or _open[-1][0] is not self:
            return False  # opened while tracing was off
        _, record, held = _open.pop()
        if record is None:
            end = torch.cuda.Event(enable_timing=True, external=True)
            end.record()
            held[2] = _marks.last = end
            return False
        if record.events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            record.events = (record.events[0], end)
        held.__exit__(None, None, None)
        record.end_ns = time.perf_counter_ns()
        return False


def tracing() -> bool:
    """Whether spans record now: whether ``torch.profiler`` records."""
    return _profiler._is_profiler_enabled


@contextlib.contextmanager
def marking():
    """Inside, each span records a timing event into the graph being
    captured at its start and at its end, and makes no host record;
    yields the capture's ``Marks``."""
    global _marks
    if _marks is not None:
        raise RuntimeError("marking() does not nest")
    _marks = Marks()
    try:
        yield _marks
    finally:
        _marks = None


@contextlib.contextmanager
def setup_timer(name: str):
    """Add the seconds of the block to ``SETUP_S[name]``, always."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        SETUP_S[name] = SETUP_S.get(name, 0.0) + time.perf_counter() - t0


def _read(marks: Marks) -> None:
    """Append the last replay of ``marks`` to the samples (its events
    have completed)."""
    if not marks.replayed:
        return
    _samples.append(tuple((name, start.elapsed_time(end)) for name, start, end in marks.stages))
    marks.replayed = False
    _replayed.remove(marks)


def _resolve() -> None:
    """Read every pending device time, waiting for its end event."""
    for marks in list(_replayed):
        marks.last.synchronize()
        _read(marks)
    for r in _spans:
        if r.events is not None and len(r.events) == 2:
            start, end = r.events
            end.synchronize()
            r.device_ms, r.events = start.elapsed_time(end), None


def peek() -> Trace:
    """The recorder's closed spans and samples, left in place."""
    _resolve()
    return Trace([r for r in _spans if r.end_ns is not None], list(_samples))


def take() -> Trace:
    """The recorder's closed spans and samples; the recorder keeps only
    the spans still open."""
    trace = peek()
    _spans[:] = [r for r in _spans if r.end_ns is None]
    _samples.clear()
    return trace
