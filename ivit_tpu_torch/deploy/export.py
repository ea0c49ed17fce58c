"""Serialized engines: one engine forward as a ``torch.export`` program.

Counterpart of ``ivit_tpu/deploy/export.py`` (StableHLO through
``jax.export``): the deployment product that runs without the
model-building Python. ``export_engine`` traces a ``build_vit_infer`` or
``build_swin_infer`` function at one fixed (batch, img, img, 3) float32
input on the engine's device into an ``ExportedProgram``: the aten ops
of the plain tensor code, and one ``ivit::`` operator node for each
kernel launch (every kernel wrapper calls its operator, ``kernels``),
with the integer weights and the ratios as constants, as JAX's export
bakes them. ``torch.export.save`` writes it to bytes.

``load_engine`` reads the bytes back with ``torch.export.load``. It needs
torch and the operator library (``ivit_tpu_torch.kernels``, whose import
registers the ``ivit::`` operators), not the artifact or the engine's
code. The reloaded program launches the kernels the live engine
launches, each counting its launches as the live one does, and gives its
logits bit for bit.

Like JAX's, the program is specialized to one batch and one device: it
takes images of its batch only, and a program exported on the card holds
CUDA tensors, so ``torch.export.load`` raises for it on a machine
without one.
"""

from __future__ import annotations

import io

import torch

from .. import kernels  # noqa: F401  (registers the ivit:: operators a program calls)


class _Engine(torch.nn.Module):
    """An engine function as the module ``torch.export`` traces."""

    def __init__(self, infer):
        super().__init__()
        self.infer = infer

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.infer(images)


def export_engine(infer, batch_size: int, img_size: int = 224, path: str | None = None) -> bytes:
    """Serialize ``infer`` (a ``build_vit_infer`` or ``build_swin_infer``
    function) at ``batch_size`` images of ``img_size``² on the engine's
    device; returns the bytes and writes them to ``path`` when given.
    The engine runs once on zeros first (its launches count), so that
    the constants it makes at its first call exist outside the trace, as
    ``capture_infer`` warms up."""
    images = torch.zeros((batch_size, img_size, img_size, 3), dtype=torch.float32, device=infer.device)
    infer(images)
    program = torch.export.export(_Engine(infer), (images,))
    program.example_inputs = None  # the traced zeros: as large as a batch of images, and not needed
    buf = io.BytesIO()
    torch.export.save(program, buf)
    data = buf.getvalue()
    if path is not None:
        with open(path, "wb") as f:
            f.write(data)
    return data


def load_engine(path_or_bytes):
    """Deserialize an exported engine from a path or bytes; returns
    ``images -> logits`` (run under ``torch.inference_mode``), with the
    program as ``.program``, the shape of the images it takes as
    ``.images_shape`` and their device as ``.device``. Raises for a
    program exported on the card on a machine without one."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        path_or_bytes = io.BytesIO(path_or_bytes)
    program = torch.export.load(path_or_bytes)
    module = program.module()

    @torch.inference_mode()
    def engine(images: torch.Tensor) -> torch.Tensor:
        return module(images)

    images = next(n for n in program.graph.nodes if n.name == program.graph_signature.user_inputs[0])
    engine.program = program
    engine.images_shape = tuple(images.meta["val"].shape)
    engine.device = images.meta["val"].device
    return engine
