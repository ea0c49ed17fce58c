"""Serialized engines (``deploy.export``) on the CPU, against the live
port engine and against JAX's serialized engine.

For the main path (K1 + K3 + K9), route A (K2 + K4 + K3), route B (K6 + K5 +
K3), ``strict_dyadic`` (no kernel) and a two-stage Swin (K7 + K3), on
seeded tiny artifacts (DeiT img 32, patch 8, depth 2; Swin img 16, patch
2, depths (2, 2), window 4):

* the exported graph calls aten operators and ``ivit::`` operators only
  (and ``operator.getitem``, which takes K6's two outputs apart), each
  ``ivit::`` operator as often as the live engine launches its kernel in
  a forward (K1 + K3 + K9 at depth 2: 2, 5 and 2);
* reloaded from the bytes in a fresh ``python`` process that builds no
  engine (``scripts/torch_reload_engine.py``), the logits are bit-equal
  (tolerance 0) to the live engine's, and to ``ivit_tpu.deploy.
  load_engine`` of JAX's export of ``build_vit_infer(artifact,
  use_pallas=False)`` (or ``build_swin_infer``) on the same artifact and
  images;
* the program is specialized to its batch, and a program whose tensors
  lie on the card does not load on a machine without one.
"""

import io
import json
import operator
import os
import re
import subprocess
import sys
import zipfile
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivit_tpu.deploy import build_vit_infer as jax_build_vit_infer
from ivit_tpu.deploy import export_engine as jax_export_engine
from ivit_tpu.deploy import load_engine as jax_load_engine
from ivit_tpu.deploy.swin_engine import build_swin_infer as jax_build_swin_infer
from ivit_tpu_torch.deploy import (
    build_swin_infer,
    build_vit_infer,
    export_engine,
    load_engine,
    synthetic_swin_artifact,
    synthetic_vit_artifact,
)
from ivit_tpu_torch.kernels import WRAPPERS
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 2
VIT = dict(img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=2)
SWIN = dict(img_size=16, patch_size=2, embed_dim=16, depths=(2, 2), num_heads=(2, 4), window_size=4, num_classes=8)
SM8 = dict(softmax_bits=8, gelu_stable=True)
SM16 = dict(softmax_bits=16, gelu_stable=False)
# path: (model, artifact overrides, engine kwargs, ivit:: operator nodes = launches a forward)
PATHS = {
    "main": ("vit", SM8, dict(kernels=("attention", "layernorm")), {"K1": 2, "K3": 5, "K9": 2}),
    "route-a": ("vit", SM16, dict(kernels=("layernorm", "attention2", "linear_gelu")), {"K2": 2, "K4": 2, "K3": 5}),
    "route-b": ("vit", SM16, dict(kernels=("layernorm", "softmax", "gelu")), {"K6": 2, "K5": 2, "K3": 5}),
    "strict": ("vit", SM8, dict(kernels=(), strict_dyadic=True), {}),
    # 4 blocks x 2 norms, the patch merging's and the final norm
    "swin": ("swin", {}, dict(kernels=("attention", "layernorm")), {"K7": 4, "K3": 10}),
}
OP_NAMES = {f"ivit.{w.__name__}.default": name for name, w in WRAPPERS.items()}


def _artifact(path):
    model, over, _, _ = PATHS[path]
    if model == "swin":
        return synthetic_swin_artifact("swin_tiny", seed=0, **SWIN)
    return synthetic_vit_artifact("deit_tiny", seed=0, **over, **VIT)


def _live(path):
    model, _, kw, _ = PATHS[path]
    return (build_swin_infer if model == "swin" else build_vit_infer)(_artifact(path), "cpu", **kw)


def _images(path):
    size = SWIN["img_size"] if PATHS[path][0] == "swin" else VIT["img_size"]
    return np.random.default_rng(7).standard_normal((BATCH, size, size, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def reloaded(tmp_path_factory):
    """Each path exported to a file, then every file run by one fresh
    process; path → (live logits, reloaded logits, the process's line)."""
    tmp = tmp_path_factory.mktemp("engines")
    live, files = {}, []
    for path in PATHS:
        images = _images(path)
        infer = _live(path)
        live[path] = infer(torch.from_numpy(images)).numpy()
        np.save(tmp / f"{path}.npy", images)
        files.append(str(tmp / f"{path}.pt2"))
        export_engine(infer, BATCH, images.shape[1], path=files[-1])
    out = {}
    # one process per image size (the script takes one image file)
    for size_paths in ([p for p in PATHS if PATHS[p][0] == "vit"], [p for p in PATHS if PATHS[p][0] == "swin"]):
        run = subprocess.run(
            [sys.executable, os.path.join(REPO, "scripts", "torch_reload_engine.py"), str(tmp / f"{size_paths[0]}.npy"),
             *(str(tmp / f"{p}.pt2") for p in size_paths)],
            capture_output=True, text=True, timeout=300, cwd=REPO)
        assert run.returncode == 0, run.stderr
        lines = [json.loads(line) for line in run.stdout.splitlines()]
        for p, line in zip(size_paths, lines):
            out[p] = (live[p], np.load(tmp / f"{p}.pt2.logits.npy"), line)
    return out


@pytest.mark.parametrize("path", sorted(PATHS))
def test_graph_holds_aten_and_one_ivit_op_per_launch(path):
    program = load_engine(export_engine(_live(path), BATCH, _images(path).shape[1])).program
    targets = [n.target for n in program.graph.nodes if n.op == "call_function"]
    ops = Counter(str(t) for t in targets)
    for t in targets:
        assert t is operator.getitem or (
            isinstance(t, torch._ops.OpOverload) and t.namespace in ("aten", "ivit")), t
    ivit = {OP_NAMES[name]: n for name, n in ops.items() if name.startswith("ivit.")}
    assert ivit == PATHS[path][3]
    assert (operator.getitem in targets) == ("K6" in ivit)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_reloaded_engine_equals_live_and_jax(path, reloaded):
    live, ours, line = reloaded[path]
    np.testing.assert_array_equal(ours, live)
    assert line["device"] == "cpu" and line["launches"] == {}  # the CPU runs the plain versions
    model, _, kw, _ = PATHS[path]
    art = _artifact(path)
    if model == "swin":
        jax_infer = jax_build_swin_infer(art, use_pallas=False)
    else:
        jax_infer = jax_build_vit_infer(art, use_pallas=False, strict_dyadic=kw.get("strict_dyadic", False))
    images = _images(path)
    theirs = jax_load_engine(jax_export_engine(jax_infer, BATCH, images.shape[1]))(jnp.asarray(images))
    np.testing.assert_array_equal(ours, np.asarray(theirs))


def test_engine_file_and_batch(tmp_path):
    """``path=`` writes the bytes returned; the program takes its batch only."""
    infer = _live("main")
    images = torch.from_numpy(_images("main"))
    data = export_engine(infer, BATCH, VIT["img_size"], path=str(tmp_path / "e.pt2"))
    assert (tmp_path / "e.pt2").read_bytes() == data
    engine = load_engine(str(tmp_path / "e.pt2"))
    assert engine.device == torch.device("cpu")
    torch.testing.assert_close(engine(images), infer(images), rtol=0, atol=0)
    with pytest.raises((AssertionError, RuntimeError), match=r"shape\[0\] to be equal to 2|size\(\)\[0\] == 2"):
        engine(torch.cat([images, images[:1]]))


def test_card_program_does_not_load_without_a_card():
    """A program exported on the card records its tensors there; rewritten
    so, this CPU program must not load where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    data = export_engine(_live("main"), BATCH, VIT["img_size"])
    src, out = zipfile.ZipFile(io.BytesIO(data)), io.BytesIO()
    with zipfile.ZipFile(out, "w") as dst:
        for info in src.infolist():
            body = src.read(info.filename)
            if info.filename.endswith(".json"):
                body = re.sub(rb'"type": "cpu", "index": null', b'"type": "cuda", "index": 0', body)
            dst.writestr(info, body)
    assert out.getvalue() != data
    with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
        load_engine(out.getvalue())
