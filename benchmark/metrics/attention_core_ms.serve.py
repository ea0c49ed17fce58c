"""Device ms a forward in the engine's attention cores: the stage times of
the ``engine.attention_core`` spans (the attention kernel, K1 or K10, or
its plain chain, inside each ``engine.attention``) in a replay of the
marked CUDA graph (``deploy/graphs.py``), summed over the replay, mean
over the replays the traced window sampled. None where the program has
no such span."""

from benchmark import port_spans


def read(view):
    return port_spans.stage_ms("engine.attention_core")
