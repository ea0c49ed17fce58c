"""A configuration, a traffic mix and a per-layer metric added as new
files, with entries in ``BENCHMARK.json``, are found with no edit to the
harness."""

import json
import shutil

import pytest

from benchmark import spec
from benchmark.trace import TraceView


@pytest.fixture
def root(tmp_path):
    """A copy of the benchmark with one new configuration, mix, metric and
    cell added as files and entries."""
    shutil.copytree(spec.ROOT + "/benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(open(spec.ROOT + "/BENCHMARK.json").read())
    config = json.loads((tmp_path / "benchmark/configs/deit_small_sm8.json").read_text())
    config.update(name="deit_base_sm8", model=dict(config["model"], embed_dim=768, num_heads=12))
    (tmp_path / "benchmark/configs/deit_base_sm8.json").write_text(json.dumps(config))
    (tmp_path / "benchmark/traffic/serve_b64.json").write_text(json.dumps(
        {"loop": "offline", "checks": "serve", "batch": 64, "in_flight": 2, "pool": 2, "warmup": 2,
         "trace_units": 4}))
    (tmp_path / "benchmark/metrics/busy_ms.serve.py").write_text(
        "def read(view):\n    return 1e3 * view.busy_s / view.units if view.units else None\n")
    bench["configs"].append({"name": "deit_base_sm8", "source": "https://arxiv.org/abs/2012.12877",
                             "file": "benchmark/configs/deit_base_sm8.json", "reduced": [],
                             "why": "a test configuration"})
    bench["workloads"].append({"name": "deit_b.serve_b64", "config": "deit_base_sm8", "traffic": "serve_b64",
                               "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "busy_ms.serve", "unit": "ms", "better": "lower", "source": "device_trace",
                               "layer": "Device", "moves": "images_per_s"})
    for m in bench["end_to_end"]:
        if m["name"] == "images_per_s":
            m["workloads"].append("deit_b.serve_b64")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(tmp_path)


def test_new_files_are_found(root):
    cell = spec.load("deit_b.serve_b64", root)
    assert cell.model["embed_dim"] == 768 and cell.traffic["batch"] == 64
    assert [m["name"] for m in cell.end_to_end] == ["images_per_s", "setup_s"]
    names = [m["name"] for m in cell.per_layer]
    assert "busy_ms.serve" in names  # no workloads key: every cell that reports images_per_s
    assert "K1_roofline" not in names  # listed for other cells only
    assert "busy_ms.serve" in [m["name"] for m in spec.load("swin_t.serve_b128", root).per_layer]
    assert "busy_ms.serve" not in [m["name"] for m in spec.load("deit_s.serve_b1", root).per_layer]
    view = TraceView(window_s=2.0, busy_s=1.5, device_ops=[], kernel_launches=0, units=3, images=192,
                     cell=cell, breakdown={})
    assert spec.load_module("metrics", "busy_ms.serve", root).read(view) == pytest.approx(500.0)
    assert spec.load_module("loops", cell.traffic["loop"], root).run


def test_every_named_file_exists():
    bench = json.loads(open(spec.ROOT + "/BENCHMARK.json").read())
    for w in bench["workloads"]:
        cell = spec.load(w["name"])
        spec.load_module("loops", cell.traffic["loop"])
        spec.load_module("reference", cell.config["family"])
        spec.load_module("work", cell.config["family"])
        assert cell.traffic["checks"] in cell.config["checks"]
        for m in cell.per_layer:
            assert callable(spec.load_module("metrics", m["name"]).read)
