"""On the card (marked ``cuda``; skipped without one): the cell added
with ViT-L/16 at 384². ``vit_l384.serve_b128`` at a small model over 256
tokens runs correct through its timed path and its traced window, K10
in the trace."""

import pytest
import torch

from benchmark import spec
from benchmark.tests.test_bench_vit_long import LONG
from benchmark.tests.tiny import execute


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.cuda
def test_vit_l384_cell_on_the_card(card):
    cell = spec.load("vit_l384.serve_b128")
    cell.config["model"].update(LONG)
    cell.traffic.update(batch=8, pool=2, warmup=2, trace_units=2)
    for trace in (False, True):
        r = execute(cell, trace=trace, device=card)
        assert r["correct"] is True and r["checks"]["logit_gap"]["value"] == 0.0, r["checks"]
    assert any("attention_long_kernel" in name for name, _ in r["trace"].kernels())
    assert 0 < r["metrics"]["K10_roofline"]["value"] <= 100
    assert r["metrics"]["attention_core_ms.serve"]["value"] > 0
