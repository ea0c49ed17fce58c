"""The check of what a run has loaded compares whole top-level names."""

import pytest

from benchmark.imports import forbidden_modules


@pytest.mark.parametrize("name", ["jax", "jaxlib", "flax", "ivit_tpu", "ivit_tpu.deploy.engine", "jax.numpy",
                                  "flax.linen"])
def test_refuses(name):
    assert forbidden_modules(["torch", "ivit_tpu_torch", name]) == [name.split(".")[0]]


@pytest.mark.parametrize("name", ["ivit_tpu_torch", "ivit_tpu_torch.deploy.engine", "jaxtyping", "flax_free",
                                  "benchmark.run"])
def test_passes(name):
    assert forbidden_modules(["torch", name]) == []
