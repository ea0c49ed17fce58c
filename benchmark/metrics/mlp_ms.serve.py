"""Device ms a forward in the engine's MLP halves: the stage times of the
``engine.mlp`` spans in a replay of the marked CUDA graph
(``deploy/graphs.py``), summed over the replay, mean over the replays
the traced window sampled."""

from benchmark import port_spans


def read(view):
    return port_spans.stage_ms("engine.mlp")
