"""The readers of the program's own spans (``benchmark/port_spans.py``
and the metrics that use it), on a recorder filled by hand: each reads
its number, and None where the recorder holds nothing or the program has
no recorder (as a checkout before the spans has none)."""

import sys

import pytest

from benchmark import spec
from ivit_tpu_torch.utils import spans

SERVING = ("attention_ms.serve", "mlp_ms.serve", "attention_ms.b1", "mlp_ms.b1")
TRAINING = {f"{phase}{kind}.train": (phase, kind) for phase in ("forward", "backward", "optimizer")
            for kind in ("_ms", "_host_ms")}
NEW = SERVING + ("capture_s.serve",) + tuple(TRAINING)


def _read(name):
    return spec.load_module("metrics", name).read(None)


@pytest.fixture
def recorder(monkeypatch):
    """An empty recorder in place of the program's."""
    monkeypatch.setattr(spans, "_spans", [])
    monkeypatch.setattr(spans, "_samples", [])
    monkeypatch.setattr(spans, "_replayed", [])
    monkeypatch.setattr(spans, "SETUP_S", {})
    return spans


def test_every_new_metric_is_listed_for_its_cells():
    import json

    bench = json.loads(open(spec.ROOT + "/BENCHMARK.json").read())
    listed = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        assert listed[name]["workloads"], name
        for cell in listed[name]["workloads"]:
            assert name in [m["name"] for m in spec.load(cell).per_layer]


def test_stage_readers_average_over_sampled_replays(recorder):
    recorder._samples += [
        (("engine.embed", 1.0), ("engine.attention", 2.0), ("engine.mlp", 3.0), ("engine.attention", 4.0),
         ("engine.mlp", 5.0), ("engine.head", 0.5)),
        (("engine.embed", 1.0), ("engine.attention", 4.0), ("engine.mlp", 7.0), ("engine.attention", 6.0),
         ("engine.mlp", 9.0), ("engine.head", 0.5)),
    ]
    for cell in ("serve", "b1"):
        assert _read(f"attention_ms.{cell}") == pytest.approx((6.0 + 10.0) / 2)
        assert _read(f"mlp_ms.{cell}") == pytest.approx((8.0 + 16.0) / 2)
    assert len(spans.peek().samples) == 2  # reading leaves the samples in place


def test_training_readers_average_over_steps(recorder):
    for i, phase in enumerate(("forward", "backward", "optimizer") * 2):
        step = i // 3
        start = 1_000_000 * (10 * step + i)
        recorder._spans.append(spans.Record(f"train.{phase}", None, start, start + 1_000_000 * (i + 1),
                                            device_ms=float(2 * (i + 1))))
    for name, (phase, kind) in TRAINING.items():
        i = ("forward", "backward", "optimizer").index(phase)
        host = ((i + 1) + (i + 4)) / 2
        assert _read(name) == pytest.approx(2 * host if kind == "_ms" else host), name


def test_capture_reader_reads_the_set_up_timer(recorder):
    assert _read("capture_s.serve") is None
    recorder.SETUP_S["capture_infer"] = 6.5
    assert _read("capture_s.serve") == 6.5


def test_an_empty_recorder_reads_none(recorder):
    assert all(_read(name) is None for name in NEW)


def test_spans_without_device_times_read_none_for_the_device(recorder):
    """A span recorded without timing events (on the CPU) has host ms
    alone."""
    recorder._spans.append(spans.Record("train.forward", None, 0, 3_000_000))
    assert _read("forward_ms.train") is None
    assert _read("forward_host_ms.train") == pytest.approx(3.0)


def test_without_the_programs_recorder_every_reader_reads_none(recorder, monkeypatch):
    recorder._samples.append((("engine.attention", 1.0), ("engine.mlp", 1.0)))
    recorder.SETUP_S["capture_infer"] = 1.0
    monkeypatch.setitem(sys.modules, "ivit_tpu_torch.utils.spans", None)  # import raises ImportError
    monkeypatch.delattr(sys.modules["ivit_tpu_torch.utils"], "spans")
    assert all(_read(name) is None for name in NEW)
