"""Host ms a training step spends inside its ``train.forward`` span
(``train/steps.py``), mean over the traced window's steps."""

from benchmark import port_spans


def read(view):
    return port_spans.phase_ms("train.forward", device=False)
