"""The port's spans (``ivit_tpu_torch/utils/spans.py``) on the CPU.

With tracing off nothing is recorded and no profiler range opens; under
``torch.profiler`` the engines record their stages in order and the
train step its three phases with their parents, each span also an event
of the profiler's trace, and the step computes what it computes with
tracing off, bit for bit. The artifacts are the port's seeded synthetic
ones at tiny sizes, so nothing here imports JAX. The spans' timing events
and the marked CUDA graph are tested on the card
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ivit_tpu_torch.deploy.engine import build_vit_infer
from ivit_tpu_torch.deploy.swin_engine import build_swin_infer, swin_block
from ivit_tpu_torch.deploy.swin_synthetic import synthetic_swin_artifact
from ivit_tpu_torch.deploy.synthetic import synthetic_vit_artifact
from ivit_tpu_torch.models import create_model
from ivit_tpu_torch.train import AdamW, create_train_state, make_train_step
from ivit_tpu_torch.utils import spans

VIT = dict(img_size=16, patch_size=8, num_classes=8, embed_dim=32, depth=3, num_heads=4)
# tests/test_torch_swin.py's TINY
SWIN = dict(img_size=16, patch_size=2, num_classes=8, embed_dim=16, depths=(2, 2), num_heads=(2, 4), window_size=4)


@pytest.fixture(autouse=True)
def empty_recorder():
    spans.take()
    yield
    spans.take()


def _images(size, n=2, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def vit():
    return build_vit_infer(synthetic_vit_artifact("deit_tiny", seed=1, **VIT), "cpu", kernels=())


@pytest.fixture(scope="module")
def swin():
    return build_swin_infer(synthetic_swin_artifact("swin_tiny", seed=1, **SWIN), "cpu", kernels=())


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def test_off_records_nothing_and_opens_no_range(vit, monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: opened.append(name))
    assert not spans.tracing()
    vit(_images(VIT["img_size"]))
    trace = spans.take()
    assert trace.spans == [] and trace.samples == [] and opened == []


def test_vit_engine_records_its_stages_in_order(vit):
    images = _images(VIT["img_size"])
    logits, prof = _profiled(lambda: vit(images))
    records = spans.take().spans
    top = [r for r in records if r.parent is None]
    names = [r.name for r in top]
    assert names == ["engine.embed"] + ["engine.attention", "engine.mlp"] * VIT["depth"] + ["engine.head"]
    assert all(r.device_ms is None and r.end_ns >= r.start_ns for r in records)
    assert all(a.end_ns <= b.start_ns for a, b in zip(top, top[1:]))  # they tile, in order
    # the attention core lies inside each attention half, once a block
    cores = [r for r in records if r.parent is not None]
    assert [(r.name, r.parent) for r in cores] == [("engine.attention_core", "engine.attention")] * VIT["depth"]
    halves = [r for r in top if r.name == "engine.attention"]
    assert all(h.start_ns <= c.start_ns and c.end_ns <= h.end_ns for h, c in zip(halves, cores))
    events = {e.name for e in prof.events()}
    assert set(names) | {"engine.attention_core"} <= events
    torch.testing.assert_close(logits, vit(images), rtol=0, atol=0)


def test_swin_engine_records_a_merge_for_each_stage_but_the_last(swin):
    _profiled(lambda: swin(_images(SWIN["img_size"])))
    names = [r.name for r in spans.take().spans]
    blocks = [["engine.attention", "engine.mlp"] * d for d in SWIN["depths"]]
    merged = [n for stage in blocks[:-1] for n in stage + ["engine.merge"]] + blocks[-1]
    assert names == ["engine.embed"] + merged + ["engine.head"]
    assert names.count("engine.merge") == len(SWIN["depths"]) - 1


def test_swin_block_is_its_two_halves(swin):
    """``swin_block`` (the attention half, then the MLP half) is the
    trunk's block: the first block's output from each is the same."""
    from ivit_tpu_torch.deploy.swin_engine import patch_embed, swin_trunk

    t = swin.tensors
    x = patch_embed(_images(SWIN["img_size"]), t)
    seen = []
    swin_trunk(x, t, (), on_layer=lambda layer, xs: seen.append(xs))
    blk = t["stages"][0]["blocks"][0]
    torch.testing.assert_close(swin_block(x, blk, t["config"], ()), seen[1], rtol=0, atol=0)


def _train_setup():
    model = create_model("deit_tiny", device="cpu", softmax_bits=8, gelu_stable=True, **VIT)
    state = create_train_state(model, AdamW(1e-3, weight_decay=0.05), ema_decay=0.9, device="cpu")
    step = make_train_step(model, ema_decay=0.9, grad_clip=1.0)
    rng = np.random.default_rng(21)
    images = torch.from_numpy(rng.standard_normal((4, 16, 16, 3)).astype(np.float32))
    targets = np.full((4, 8), 0.1 / 8, np.float32)
    targets[np.arange(4), rng.integers(0, 8, 4)] += 0.9
    return state, step, images, torch.from_numpy(targets)


def _after(state, metrics):
    return ({n: p.detach().clone() for n, p in state.model.named_parameters()},
            {n: b.clone() for n, b in state.model.named_buffers()},
            {n: e.clone() for n, e in state.ema_params.items()},
            [m.clone() for m in state.opt_state.mu + state.opt_state.nu],
            {k: v.clone() for k, v in metrics.items()})


def test_train_step_records_its_phases_and_computes_the_same():
    outer = spans.Span("test.step")
    results = []
    for traced in (False, True):
        state, step, images, targets = _train_setup()
        state, metrics = step(state, images, targets)  # step 1 sets the ranges
        if traced:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                with outer:
                    state, metrics = step(state, images, targets)
        else:
            state, metrics = step(state, images, targets)
        results.append(_after(state, metrics))
    records = spans.take().spans
    assert [(r.name, r.parent) for r in records] == [
        ("test.step", None), ("train.forward", "test.step"), ("train.backward", "test.step"),
        ("train.optimizer", "test.step")]
    assert all(r.host_ms >= 0 and r.device_ms is None for r in records)
    assert {"train.forward", "train.backward", "train.optimizer"} <= {e.name for e in prof.events()}
    off, on = results
    for a, b in zip(off, on):
        pairs = zip(a.values(), b.values()) if isinstance(a, dict) else zip(a, b)
        if isinstance(a, dict):
            assert a.keys() == b.keys()
        for x, y in pairs:
            torch.testing.assert_close(y, x, rtol=0, atol=0)


def test_take_clears_and_peek_keeps(vit):
    _profiled(lambda: vit(_images(VIT["img_size"])))
    n = 2 + 3 * VIT["depth"]  # embed, head; attention, its core and mlp a block
    assert len(spans.peek().spans) == n
    assert len(spans.take().spans) == n
    assert spans.take().spans == [] and spans.peek().spans == []


def test_a_span_open_at_take_is_kept():
    a, b = spans.Span("a"), spans.Span("b")
    with profile(activities=[ProfilerActivity.CPU]):
        with a:
            with b:
                pass
            inner = spans.take().spans
        rest = spans.take().spans
    assert [(r.name, r.parent) for r in inner] == [("b", "a")]
    assert [(r.name, r.parent) for r in rest] == [("a", None)]


def test_setup_timer_adds_up():
    before = spans.SETUP_S.get("test.setup", 0.0)
    for _ in range(2):
        with spans.setup_timer("test.setup"):
            pass
    assert spans.SETUP_S["test.setup"] >= before
    del spans.SETUP_S["test.setup"]
