"""The port's GPipe pipeline (``ivit_tpu_torch.parallel.pipeline``) on CPU
ranks over ``gloo``, against JAX's ``ivit_tpu.parallel.pipeline`` and
the port's sequential model.

The tiny model of ``tests/test_pipeline.py`` (img 16, patch 8, 8
classes, embed 32, depth 4, 4 heads) with JAX's calibrated variables,
carried across by ``load_flax_variables``. One spawn of four
``torch_parallel_worker`` ranks runs the ``(data, pipe, n_micro)``
meshes (1, 2, 2), (2, 2, 2), (1, 4, 4) and the degenerate (2, 1, 2), each
on the first data·pipe ranks, then 8 pipelined steps on (2, 2) and the
refused cases.

**Bounds.** The pipeline runs frozen ranges and every op per row, so
the logits equal the sequential forward's and JAX's ``apply`` (run op by
op, as ``tests/test_torch_qat_model.py`` compares it) bit for bit. The
gradients sum their float32 parts in other orders: within 1e-5 of each
leaf's largest entry against JAX's jitted ``jax.grad`` through its
``pipeline_vit_forward`` on the same mesh, and within JAX's own rtol
2e-5 / atol 1e-6 (``tests/test_pipeline.py``) against the port's
sequential gradient. The stage round trip is exact.
"""

from concurrent.futures import ThreadPoolExecutor
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivit_tpu.parallel.pipeline import from_pp_variables as jax_from_pp_variables
from ivit_tpu.parallel.pipeline import make_pp_mesh as jax_make_pp_mesh
from ivit_tpu.parallel.pipeline import pipeline_vit_forward as jax_pipeline_vit_forward
from ivit_tpu.parallel.pipeline import to_pp_variables as jax_to_pp_variables
from ivit_tpu_torch.models import create_model
from ivit_tpu_torch.nn import load_flax_variables
from ivit_tpu_torch.parallel import Mesh, make_mesh, make_pp_mesh, pp_shardings
from ivit_tpu_torch.train import soft_target_cross_entropy
from test_pipeline import calibrated, small_model

from torch_parallel_worker import pipeline_run, run_ranks
from tests.torch_threads import one_torch_thread  # noqa: F401

KW = dict(img_size=16, patch_size=8, num_classes=8, embed_dim=32, depth=4, num_heads=4)
CASES = [(1, 2, 2), (2, 2, 2), (1, 4, 4), (2, 1, 2)]
SLOW_CASES = [(2, 4, 4), (4, 2, 2)]
GRAD_RTOL = 1e-5  # of each leaf's largest entry, against JAX's pipelined gradient
TRAIN = {"mesh": (2, 2), "n_micro": 4, "steps": 8, "lr": 5e-3}
ERRORS = {"depth": (1, 3, 3, 4), "batch": (2, 2, 3, 4)}


def _name(keystr: str) -> str:
    return keystr.replace("']['", ".").strip("[]'")


@pytest.fixture(scope="module")
def jax_setup():
    """JAX's model, its calibrated variables (``test_pipeline.calibrated``
    under ``jit``: a third of the eager time, and both packages take the
    variables as given), the images and the one-hot targets."""
    model = small_model()
    images = jax.random.normal(jax.random.PRNGKey(1), (8, 16, 16, 3))
    variables = jax.tree.map(np.asarray, jax.jit(partial(calibrated, model))(jax.random.PRNGKey(0), images))
    targets = np.array(jax.nn.one_hot(jax.random.randint(jax.random.PRNGKey(2), (8,), 0, 8), 8), np.float32)
    return model, variables, np.array(images), targets


def _spec(jax_setup, cases, train=None, errors=None):
    _, variables, images, targets = jax_setup
    return {"variables": variables, "model_kw": KW, "images": images, "targets": targets, "cases": cases,
            "train": train, "errors": errors or {}}


def _sequential(jax_setup):
    """The port's sequential frozen forward and its gradient."""
    _, variables, images, targets = jax_setup
    model = load_flax_variables(create_model("deit_tiny", device="cpu", seed=0, **KW), variables)
    logits = model(torch.from_numpy(images), train=False)
    names, params = zip(*model.named_parameters())
    loss = soft_target_cross_entropy(logits, torch.from_numpy(targets))
    grads = torch.autograd.grad(loss, params, materialize_grads=True)
    return logits.detach(), dict(zip(names, grads))


def _jax_grads(jax_setup, data, pipe, n_micro):
    """JAX's gradient through its pipelined forward on a (data, pipe)
    mesh of the virtual devices, by torch name."""
    model, variables, images, targets = jax_setup
    mesh = jax_make_pp_mesh(data=data, pipe=pipe, devices=jax.devices()[:data * pipe])
    pp_vars = jax_to_pp_variables(variables, model.depth)

    def loss(params):
        logits = jax_pipeline_vit_forward(model, {"params": params, "quant_stats": pp_vars["quant_stats"]},
                                          jnp.asarray(images), mesh, n_micro)
        return -jnp.mean(jnp.sum(jnp.asarray(targets) * jax.nn.log_softmax(logits, axis=-1), axis=-1))

    grads = jax.jit(jax.grad(loss))(pp_vars["params"])
    grads = jax_from_pp_variables({"params": grads, "quant_stats": pp_vars["quant_stats"]}, model.depth)["params"]
    return {_name(jax.tree_util.keystr(k)): np.asarray(g) for k, g in jax.tree_util.tree_leaves_with_path(grads)}


def _jax_logits(jax_setup):
    """JAX's eager frozen ``apply``."""
    model, variables, images, _ = jax_setup
    return np.asarray(model.apply(variables, jnp.asarray(images), train=False))


@pytest.fixture(scope="module")
def runs(jax_setup, tmp_path_factory):
    """The four ranks' results, the port's sequential forward and
    gradient, and JAX's logits and pipelined gradients for each case:
    the ranks and JAX's pipelined gradients (a compile for each mesh)
    run side by side while JAX's eager logits compile op by op."""
    with ThreadPoolExecutor(len(CASES) + 1) as pool:
        ranks = pool.submit(run_ranks, 4, tmp_path_factory.mktemp("pp4"), pipeline_run,
                            _spec(jax_setup, CASES, TRAIN, ERRORS))
        jax_grads = {case: pool.submit(_jax_grads, jax_setup, *case) for case in CASES}
        jax_logits, sequential = _jax_logits(jax_setup), _sequential(jax_setup)
        return {"ranks": ranks.result(), "sequential": sequential, "jax_logits": jax_logits,
                "jax_grads": {case: g.result() for case, g in jax_grads.items()}}


def _case_ranks(ranks, case):
    return [r["cases"][case] for r in ranks if case in r["cases"]]


def _assert_forward(ranks, case, jax_logits, sequential):
    np.testing.assert_array_equal(sequential[0].numpy(), jax_logits)
    got = _case_ranks(ranks, case)
    assert len(got) == case[0] * case[1]
    for r in got:
        torch.testing.assert_close(r["logits"], sequential[0], rtol=0, atol=0)


def _assert_gradients(ranks, case, theirs, sequential):
    seq = sequential[1]
    for r in _case_ranks(ranks, case):
        assert list(r["grads"]) == list(seq)
        for name, g in r["grads"].items():
            ref = theirs[name]
            np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=GRAD_RTOL * float(np.abs(ref).max()),
                                       err_msg=f"{case} {name} against JAX")
            np.testing.assert_allclose(g.numpy(), seq[name].numpy(), rtol=2e-5, atol=1e-6,
                                       err_msg=f"{case} {name} against the sequential gradient")


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_pipelined_forward_equals_sequential_and_jax(runs, case):
    """Every rank of the mesh holds the global batch's logits, equal to
    the port's sequential frozen forward and to JAX's eager ``apply``,
    tolerance 0."""
    _assert_forward(runs["ranks"], case, runs["jax_logits"], runs["sequential"])


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_pipelined_gradients_match_jax_and_sequential(runs, case):
    """The whole gradient (the replicated leaves summed over the pipe
    group, everything averaged over the data group) within 1e-5 of each
    leaf's largest entry against JAX's pipelined ``jax.grad``, and within
    rtol 2e-5 / atol 1e-6 of the sequential gradient."""
    _assert_gradients(runs["ranks"], case, runs["jax_grads"][case], runs["sequential"])


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_stage_round_trip_is_exact(runs, case):
    """A whole state cut to each rank's stage and gathered back: every
    parameter, range, moment and EMA leaf equal, tolerance 0, in the
    whole model's order; each stage holds its L = depth / S blocks."""
    data, pipe, _ = case
    for i, r in enumerate(_case_ranks(runs["ranks"], case)):
        assert r["round_trip"]
        s, L = i % pipe, KW["depth"] // pipe
        held = {int(n.split(".")[0][len("blocks_"):]) for n in r["params"] if n.startswith("blocks_")}
        assert held == set(range(s * L, (s + 1) * L))


def test_each_rank_holds_only_its_blocks_after_a_step(runs):
    """On (2, 2) each rank holds the prologue, the epilogue and its own
    two blocks: parameters, AdamW moments and EMA, after a step."""
    for r in runs["ranks"]:
        held = r["train"]["held"]
        s = r["rank"] % 2
        blocks = {n.split(".")[0] for n in held["params"] if n.startswith("blocks_")}
        assert blocks == {f"blocks_{2 * s}", f"blocks_{2 * s + 1}"}
        assert held["mu"] == held["nu"] == len(held["params"])
        assert held["ema"] == held["params"]
        assert {"cls_token", "pos_embed", "head.kernel", "norm.scale"} <= set(held["params"])


def test_pipelined_training_learns(runs):
    """Eight pipelined steps on (2, 2) with 4 microbatches (AdamW 5e-3,
    clip 1.0, EMA): the loss falls; loss, accuracy and the gathered
    parameters are the same on every rank."""
    ranks = runs["ranks"]
    losses = [loss for loss, _ in ranks[0]["train"]["losses"]]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    for r in ranks[1:]:
        assert r["train"]["losses"] == ranks[0]["train"]["losses"]
        for name, p in ranks[0]["train"]["params"].items():
            assert torch.equal(r["train"]["params"][name], p), name
    assert all(r["train"]["step"] == TRAIN["steps"] for r in ranks)


def test_indivisible_depth_and_batch_raise(runs):
    """Depth 3 over 3 stages is fine, depth 4 over 3 raises; 3
    microbatches of a batch of 8 raise."""
    for r in runs["ranks"]:
        errors = r["errors"]
        if "depth" in errors:
            assert errors["depth"] == "depth 4 not divisible by 3 stages"
        if "batch" in errors:
            assert errors["batch"] == "batch 8 not divisible by 3 microbatches"
    assert sum("depth" in r["errors"] for r in runs["ranks"]) == 3


def test_pp_shardings_place_the_blocks_by_stage():
    """Each block's leaves on stage i // L, the prologue and epilogue on
    every stage (None), as JAX's ``pp_shardings`` lays the stacked depth
    axis over ``pipe``; a depth the stages do not divide raises."""
    model = create_model("deit_tiny", device="cpu", **KW)
    names = [n for n, _ in model.named_parameters()]
    placed = pp_shardings(names, 4, Mesh(1, 2, 0, "cpu", {}, axis="pipe"))
    for n in names:
        want = None if not n.startswith("blocks_") else int(n.split(".")[0][7:]) // 2
        assert placed[n] == want, n
    with pytest.raises(ValueError, match="depth 4 not divisible by 3 stages"):
        pp_shardings(names, 4, Mesh(1, 3, 0, "cpu", {}, axis="pipe"))


def test_make_mesh_without_a_card_raises(monkeypatch):
    """Without CUDA and without ``device="cpu"`` a mesh raises rather
    than falling back to the CPU; with it the mesh is on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (make_mesh, make_pp_mesh):
        with pytest.raises(RuntimeError, match="no CUDA device; pass device='cpu'"):
            make(1, 1)
        assert make(1, 1, device="cpu").device == torch.device("cpu")


@pytest.mark.slow
@pytest.mark.parametrize("case", SLOW_CASES, ids=lambda c: "x".join(map(str, c)))
def test_eight_ranks_forward_and_gradients(jax_setup, tmp_path, case):
    """JAX's 8-device meshes, (2, 4, 4) and (4, 2, 2): the forward and
    the gradients within the bounds above."""
    ranks = run_ranks(8, tmp_path, pipeline_run, _spec(jax_setup, [case]))
    sequential = _sequential(jax_setup)
    _assert_forward(ranks, case, _jax_logits(jax_setup), sequential)
    _assert_gradients(ranks, case, _jax_grads(jax_setup, *case), sequential)
