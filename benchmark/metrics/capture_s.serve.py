"""Seconds the program spent in ``deploy/graphs.py:capture_infer``: its
warm-up forwards and both captures (the plain graph and the marked one),
from the program's set-up timer."""

from benchmark import port_spans


def read(view):
    return port_spans.setup_s("capture_infer")
