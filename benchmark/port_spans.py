"""What the per-layer metrics read from the program's own recorder
(``ivit_tpu_torch.utils.spans``). The program records only while
``torch.profiler`` records, so the recorder holds the traced window's
spans and samples alone; its set-up timer (``SETUP_S``) is always on.
Every function returns None where the program has no recorder or the
recorder holds nothing to read."""

from __future__ import annotations


def recorder():
    """The program's ``utils.spans`` module, or None where it has none."""
    try:
        from ivit_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans


def stage_ms(stage: str) -> float | None:
    """Device ms a forward in the stages named ``stage`` (their sum over
    a sampled replay), mean over the sampled replays."""
    spans = recorder()
    if spans is None:
        return None
    sums = [sum(ms for name, ms in sample if name == stage) for sample in spans.peek().samples
            if any(name == stage for name, _ in sample)]
    return sum(sums) / len(sums) if sums else None


def phase_ms(phase: str, device: bool) -> float | None:
    """Mean ms of the spans named ``phase``: device ms between their
    timing events, or host ms inside them."""
    spans = recorder()
    if spans is None:
        return None
    records = [r for r in spans.peek().spans if r.name == phase]
    values = [r.device_ms if device else r.host_ms for r in records]
    if not values or any(v is None for v in values):
        return None
    return sum(values) / len(values)


def setup_s(name: str) -> float | None:
    """Seconds the program's set-up step ``name`` took, summed over its calls."""
    spans = recorder()
    return None if spans is None else spans.SETUP_S.get(name)
