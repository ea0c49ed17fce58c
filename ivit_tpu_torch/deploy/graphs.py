"""One forward of an engine, captured once as a CUDA graph and replayed.

The port's counterpart of ``jax.jit(build_*_infer(artifact)).lower(images)
.compile()`` (``evaluate_latency.py:118-135``, ``bench.py:166``): an eager
forward launches a few hundred kernels from Python, so at batch 1 the
device idles while the host launches; a replay launches them all in one call.

``capture_infer`` follows PyTorch's whole-network capture recipe:
warm-up forwards on a side stream (they fill what a forward makes at its
first call: the GELU tables of K4 and K5, the spec's scalar constants,
cuBLAS's workspaces and its choice of GEMM), then one forward captured on
that stream into a ``torch.cuda.CUDAGraph`` from a static NHWC float32
input. An engine may be captured because its forward copies nothing from
the host and never waits for the device: a capture that meets either
fails. Every tensor the captured forward allocates (the GEMMs' padding,
the activations) lives in the graph's private memory pool; the tensors it
reads (the engine's weights and ratios) stay where they are, so the
replay function holds the engine: a caller may drop its own reference.

Each kernel wrapper adds to its ``launches`` count on the host when it
records its launch, so the counts rise during warm-up and capture, and a
replay adds nothing: ``replay.launches`` holds the launches of one
forward, counted during the capture.

A replay runs no Python, so the engine's spans (``utils/spans.py``)
record nothing in it. ``capture_infer`` therefore captures the forward a
second time under ``spans.marking()``, with a timing event at the start
and end of each span, and replays that marked graph instead of the plain
one while ``torch.profiler`` records and the marked graph's previous
replay has finished; each marked replay gives the recorder one sample of
stage times. With tracing off, the plain graph replays as if the marked
one did not exist. Both graphs run the same kernels, so their logits are
equal bit for bit. ``spans.SETUP_S["capture_infer"]`` sums the seconds
spent in ``capture_infer``.
"""

from __future__ import annotations

import torch

from ..core.device import target_device
from ..kernels import WRAPPERS
from ..utils import spans

WARMUP = 3
FORWARDS = WARMUP + 2  # the forwards a capture runs: the warm-ups, the plain capture and the marked one


def capture_infer(infer, batch: int, img_size: int, device="cuda"):
    """Capture one forward of ``infer`` (a ``build_vit_infer`` or
    ``build_swin_infer`` function, or a reloaded ``deploy.load_engine``
    engine) at ``batch`` images of ``img_size``² on a CUDA ``device``.

    Returns ``replay(images)``: it copies the (batch, img_size, img_size,
    3) images into the graph's input, replays the graph and returns a
    copy of the logits, so logits a caller keeps do not change at the
    next call. ``replay.launches`` maps each kernel (``"K1"`` …) to its
    launches in one forward; ``replay.graph`` is the graph,
    ``replay.marked`` the marked graph (module docstring). Raises
    ``RuntimeError`` on the CPU, where there is nothing to capture: run
    the eager engine there."""
    device = target_device(device)
    if device.type != "cuda":
        raise RuntimeError(f"capture_infer: CUDA graphs need a CUDA device, not {device}; run the eager engine")
    with spans.setup_timer("capture_infer"):
        images = torch.zeros((batch, img_size, img_size, 3), dtype=torch.float32, device=device)
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            for _ in range(WARMUP):
                infer(images)
        torch.cuda.current_stream(device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        before = {name: wrapper.launches for name, wrapper in WRAPPERS.items()}
        with torch.cuda.graph(graph, stream=stream):
            logits = infer(images)
        launches = {name: wrapper.launches - before[name] for name, wrapper in WRAPPERS.items()}
        # The marked graph reads the same input and allocates from the
        # plain graph's pool, so it may reuse the plain graph's
        # intermediates. That is safe: both replay on the caller's one
        # stream, one after the other, and each replay's logits are
        # cloned on that stream before the other graph can run.
        marked = torch.cuda.CUDAGraph()
        with spans.marking() as marks, torch.cuda.graph(marked, pool=graph.pool(), stream=stream):
            marked_logits = infer(images)

    @torch.inference_mode()
    def replay(x: torch.Tensor) -> torch.Tensor:
        images.copy_(x)
        if spans.tracing() and marks.ready():
            marks.replay(marked)
            return marked_logits.clone()
        graph.replay()
        return logits.clone()

    replay.graph = graph
    replay.marked = marked
    replay.launches = {name: n for name, n in launches.items() if n}
    # the graph reads the engine's weights and tables at their addresses:
    # they must live as long as the graph, whatever the caller keeps
    replay.infer = infer
    return replay
