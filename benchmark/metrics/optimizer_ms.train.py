"""Device ms a training step spends in its ``train.optimizer`` span
(``train/steps.py``), between the span's timing events, mean over the
traced window's steps."""

from benchmark import port_spans


def read(view):
    return port_spans.phase_ms("train.optimizer", device=True)
