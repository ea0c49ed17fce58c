"""The port's tensor-parallel QAT step with sequence parallelism and
ZeRO-1 (``ivit_tpu_torch.parallel.tensor_parallel``,
``train.make_train_step(..., mesh=)``) on CPU ranks over ``gloo``.

One spawn of two ``torch_parallel_worker`` ranks runs, on a ``(1, 2)``
mesh, two steps at a global batch of 8 (AdamW, the EMA, the clip,
mixup/cutmix, dropout, attention dropout and drop path 0.1) of:

* JAX's tiny DeiT of ``tests/test_sp.py`` (image 16, patch 4: 17
  tokens; dim 32, 4 heads, depth 2) at sm16 and sm8, each with the
  row-max and the stable ShiftGELU; tensor-parallel, then sequence-
  parallel (17 tokens over 2 ranks: 9 and 8), then each with ``remat``;
* the dryrun's Swin (heads (2, 4)) and one with heads (3, 6), whose
  3-head stage-1 attention the axis of 2 leaves whole;
* the float models (``deit_tiny_fp32`` at the DeiT's size,
  ``swin_tiny_fp32`` with heads (3, 6)), tensor-parallel;
* the DeiT from JAX's init variables, one step with drop path 0 and no
  mixup, tensor- and sequence-parallel, against JAX's jitted
  ``make_train_step`` on ``make_mesh(data=1, model=2)`` (with and without
  ``seq_constraint``);
* sequence parallelism over layers the axis leaves whole: a 3-head DeiT
  (dim 48: its attention whole, its Mlp split) and one whose Mlp is
  whole too (hidden 51), each tensor- and sequence-parallel, and the
  3-head one from JAX's init variables against JAX's ``seq_constraint``
  step.

One spawn of four ranks runs the sm16 DeiT on a ``(2, 2)`` mesh: tensor-
parallel, with ZeRO-1, and sequence-parallel with ZeRO-1 and ``remat``.
The single-process steps on the global batch run in this process.

**Bounds.** Every cross-rank sum in the forward is a sum of integers, so
step 1's logits, every ``QuantAct`` range and every weight scale equal
the single-process step's bit for bit. The gradients sum their float32
parts over the model group (and the data group) in another order than
one backward does: each leaf within GRAD_RTOL of its largest entry, as
in ``tests/test_torch_parallel_train.py``, whose parameter bounds after
two steps hold here too. Step 2's forward may part where step 1's
rounding moved a weight across a scale (the Swin with heads (2, 4) does
at this size), so it is held only through the parameters' bounds.
Sequence parallelism sums the LayerNorms' gradients over the ranks'
tokens in parts, so it equals the tensor-parallel step bit for bit in
the forward and within GRAD_RTOL in the gradient. ZeRO-1 and ``remat``
change no arithmetic: tolerance 0 against the step without them.
A float model's row-parallel fc2 sums float32 partial products over the
group, so its logits are held, as the gradients are, within
GRAD_RTOL of the largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ivit_tpu.models import VisionTransformer as JaxViT
from ivit_tpu.parallel import data_sharding as jax_data_sharding
from ivit_tpu.parallel import make_mesh as jax_make_mesh
from ivit_tpu.parallel import param_shardings as jax_param_shardings
from ivit_tpu.parallel import seq_constraint as jax_seq_constraint
from ivit_tpu.parallel import zero1_shardings as jax_zero1_shardings
from ivit_tpu.train import create_train_state as jax_create_train_state
from ivit_tpu.train import make_train_step as jax_make_train_step
from ivit_tpu_torch.models import create_model
from ivit_tpu_torch.parallel import Mesh, param_shardings, param_slices, shard_artifact, zero1_shardings
from ivit_tpu_torch.train import MixupConfig, mixup_cutmix
from ivit_tpu_torch.train.augment import one_hot_smooth

from torch_parallel_worker import as_numpy, run_ranks, tp_variant, train_tp

VIT = dict(img_size=16, patch_size=4, num_classes=8, embed_dim=32, depth=2, num_heads=4)
SWIN = dict(img_size=16, patch_size=2, num_classes=16, embed_dim=16, depths=(2, 2), num_heads=(2, 4), window_size=4)
DROPS = dict(drop_rate=0.1, attn_drop_rate=0.1, drop_path_rate=0.1)
LR = 1e-3
# the bounds of tests/test_torch_parallel_train.py
GRAD_RTOL = 1e-5
LOSS_ULPS = 4
PARAM_ATOL = 1e-3 * LR
SMALL_GRAD = 1e-2
ADAM_ATOL = 2 * 3 * LR


def _batches(n, classes, mixup):
    rng = np.random.default_rng(21)
    for i in range(n):
        x = torch.from_numpy(rng.standard_normal((8, 16, 16, 3)).astype(np.float32))
        labels = torch.from_numpy(rng.integers(0, classes, 8))
        if mixup:
            x, t = mixup_cutmix(x, labels, MixupConfig(num_classes=classes), np.random.default_rng((5, i)),
                                device="cpu")
        else:
            t = one_hot_smooth(labels, classes, 0.1)
        yield x.numpy(), t.numpy(), 1000 + i


def _spec(model, kw, **flags):
    classes = kw["num_classes"]
    return {"model": model, "model_kw": dict(kw, **DROPS), "lr": LR, "wd": 0.05, "ema": 0.9, "clip": 1.0,
            "batches": list(_batches(2, classes, mixup=True)), **flags}


VIT_CASES = {f"sm{bits}-{'stable' if stable else 'rowmax'}": _spec("deit_tiny", dict(VIT, softmax_bits=bits,
                                                                                      gelu_stable=stable))
             for bits in (16, 8) for stable in (False, True)}
# sequence parallelism where the model axis of 2 leaves layers whole: 3 heads
WHOLE = {"heads3": dict(VIT, embed_dim=48, num_heads=3), "heads3-mlp51": dict(VIT, embed_dim=48, num_heads=3,
                                                                              mlp_ratio=51 / 48)}
WHOLE_CASES = {name: _spec("deit_tiny", kw) for name, kw in WHOLE.items()}
SWIN_CASES = {"swin-dryrun": _spec("swin_tiny", SWIN),
              "swin-heads36": _spec("swin_tiny", dict(SWIN, embed_dim=24, num_heads=(3, 6)))}
CASES = {**VIT_CASES, **SWIN_CASES, **WHOLE_CASES}
FLOAT_CASES = {"fp32-vit": _spec("deit_tiny_fp32", VIT),
               "fp32-swin-heads36": _spec("swin_tiny_fp32", dict(SWIN, embed_dim=24, num_heads=(3, 6)))}


def _jax_state(seq_mesh=None, kw=VIT):
    jm = JaxViT(**kw) if seq_mesh is None else JaxViT(**kw, act_constraint=jax_seq_constraint(seq_mesh))
    images = jnp.asarray(next(_batches(1, 8, mixup=False))[0])
    return jm, jax_create_train_state(jm, jax.random.PRNGKey(0), images[:1], optax.adamw(LR), ema_decay=0.99)


def _jax_spec(variables, kw=VIT, **flags):
    return {"model": "deit_tiny", "model_kw": dict(kw), "variables": variables, "lr": LR, "wd": 1e-4, "ema": 0.99,
            "clip": None, "batches": list(_batches(1, 8, mixup=False)), **flags}


def _jax_variables(kw=VIT):
    _, jstate = _jax_state(kw=kw)
    return jax.tree.map(np.asarray, {"params": jstate.params, "quant_stats": jstate.quant_stats})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    variables = _jax_variables()
    jax_specs = {"jax-tp": _jax_spec(variables), "jax-sp": _jax_spec(variables, seq=True),
                 "jax-sp-heads3": _jax_spec(_jax_variables(WHOLE["heads3"]), WHOLE["heads3"], seq=True)}
    two = {name: spec for name, spec in {**CASES, **FLOAT_CASES}.items()}
    two.update({f"{name}-sp": dict(spec, seq=True) for name, spec in {**VIT_CASES, **WHOLE_CASES}.items()})
    two.update({"remat-tp": dict(VIT_CASES["sm16-rowmax"], remat=True),
                "remat-sp": dict(VIT_CASES["sm16-rowmax"], remat=True, seq=True)})
    two.update(jax_specs)
    four = {"2x2-tp": VIT_CASES["sm16-rowmax"], "2x2-zero1": dict(VIT_CASES["sm16-rowmax"], zero1=True),
            "2x2-sp-zero1-remat": dict(VIT_CASES["sm16-rowmax"], zero1=True, seq=True, remat=True)}
    r2 = run_ranks(2, tmp_path_factory.mktemp("tp2"), train_tp, [(s, (1, 2)) for s in two.values()])
    r4 = run_ranks(4, tmp_path_factory.mktemp("tp4"), train_tp, [(s, (2, 2)) for s in four.values()])
    single = {name: tp_variant(spec, None) for name, spec in {**CASES, **FLOAT_CASES}.items()}
    return {"two": {name: [r[i] for r in r2] for i, name in enumerate(two)},
            "four": {name: [r[i] for r in r4] for i, name in enumerate(four)},
            "single": single, "jax_specs": jax_specs}


def _logits(ranks, step, data=1):
    """The global batch's logits: each data row's rows in order (every
    model rank of a row holds them whole)."""
    model = len(ranks) // data
    return torch.cat([ranks[d * model]["steps"][step]["logits"] for d in range(data)])


def _assert_forward_equal(ranks, ref, steps=(0,), data=1):
    for i in steps:
        torch.testing.assert_close(_logits(ranks, i, data), ref["steps"][i]["logits"], rtol=0, atol=0,
                                   msg=f"step {i}")
        for rank, r in enumerate(ranks):
            for name, b in ref["steps"][i]["ranges"].items():
                assert torch.equal(r["steps"][i]["ranges"][name], b), (i, rank, name)


def _assert_within_bounds(r, ref):
    """The first gradient within GRAD_RTOL of each leaf's largest entry;
    the loss within LOSS_ULPS at step 1; the parameters after the last
    step within PARAM_ATOL (or 2^-22 relative) where the first gradient
    is not small and within ADAM_ATOL where it is."""
    for name, g in ref["grads"].items():
        torch.testing.assert_close(r["grads"][name], g, rtol=0, atol=GRAD_RTOL * float(g.abs().max()), msg=name)
    loss, want = np.float32(r["steps"][0]["loss"]), np.float32(ref["steps"][0]["loss"])
    assert abs(loss - want) <= LOSS_ULPS * np.spacing(abs(want))
    for name, p in ref["params"].items():
        g = ref["grads"][name].abs()
        atol = torch.where(g >= SMALL_GRAD * g.max(), PARAM_ATOL, ADAM_ATOL)
        assert bool(((r["params"][name] - p).abs() <= atol + 2.0**-22 * p.abs()).all()), name


@pytest.mark.parametrize("case", list(CASES))
def test_tp_step1_equals_single_process(runs, case):
    """Step 1 on a model axis of 2: the logits, every range on every rank
    and every weight scale (a row-parallel kernel's range spans both
    ranks' rows) equal the single-process step's, tolerance 0; for the
    ViT also at step 2."""
    ref = runs["single"][case]
    ranks = runs["two"][case]
    _assert_forward_equal(ranks, ref, steps=(0, 1) if case in VIT_CASES else (0,))
    for r in ranks:
        for name, s in ref["scales"].items():
            assert torch.equal(r["scales"][name], s), name


@pytest.mark.parametrize("case", list(CASES))
def test_eval_step_under_tp_equals_single_process(runs, case):
    """``make_eval_step(mesh=)`` on the tensor-parallel model, frozen at
    the ranges of the first forward: the logits of the whole batch on
    every rank equal the single-process eval step's, tolerance 0."""
    for r in runs["two"][case]:
        torch.testing.assert_close(r["eval_logits"], runs["single"][case]["eval_logits"], rtol=0, atol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_tp_gradients_and_parameters_within_bounds(runs, case):
    """The first gradient, the loss and the parameters after two steps
    within the bounds of the module docstring; the ranks' gathered
    parameters equal."""
    ranks = runs["two"][case]
    _assert_within_bounds(ranks[0], runs["single"][case])
    for name, p in ranks[0]["params"].items():
        assert torch.equal(ranks[1]["params"][name], p), name


@pytest.mark.parametrize("case", list(FLOAT_CASES))
def test_float_tp_step_within_bounds(runs, case):
    """A float model on a model axis of 2 (qkv by heads, its proj whole,
    fc1, fc2 and the head split; Swin's 3-head stage 1 whole): both
    steps' logits and the eval step's within GRAD_RTOL of their largest
    entry, the gradient, loss and parameters within the bounds, the
    ranks' gathered parameters equal."""
    ref, ranks = runs["single"][case], runs["two"][case]
    for i in range(2):
        want = ref["steps"][i]["logits"]
        torch.testing.assert_close(_logits(ranks, i), want, rtol=0, atol=GRAD_RTOL * float(want.abs().max()))
    for r in ranks:
        want = ref["eval_logits"]
        torch.testing.assert_close(r["eval_logits"], want, rtol=0, atol=GRAD_RTOL * float(want.abs().max()))
    _assert_within_bounds(ranks[0], ref)
    for name, p in ranks[0]["params"].items():
        assert torch.equal(ranks[1]["params"][name], p), name


@pytest.mark.parametrize("name", ["deit_tiny_fp32", "swin_tiny_fp32"])
def test_float_param_shardings_follow_jax(name):
    """A float model's specs equal JAX's ``param_shardings`` on the same
    flat tree at ``make_mesh(data=1, model=2)`` wherever the axis divides
    the heads (its proj, which JAX's rules do not name, whole); a qkv
    whose 3 heads it does not divide stays whole, where JAX cuts its
    columns."""
    kw = VIT if name.startswith("deit") else dict(SWIN, embed_dim=24, num_heads=(3, 6))
    model = create_model(name, device="cpu", **kw)
    tree = {}  # flax's tree of the float model: flat module names, then the leaf
    for n, p in model.named_parameters():
        mod, _, leaf = n.rpartition(".")
        if mod:
            tree.setdefault(mod, {})[leaf] = np.zeros(p.shape, np.float32)
        else:
            tree[n] = np.zeros(p.shape, np.float32)
    theirs = jax_param_shardings(tree, jax_make_mesh(1, 2, devices=jax.devices()[:2]))
    ours = param_shardings(model, Mesh(1, 2, 0, "cpu", {}))
    whole = 0
    for n, p in model.named_parameters():
        mod, _, leaf = n.rpartition(".")
        spec = (theirs[mod][leaf] if mod else theirs[n]).spec
        spec = tuple(spec) + (None,) * (p.ndim - len(spec))
        if "qkv" in n and n.startswith("layers_0_"):  # 3 heads at 2
            assert ours[n] == (None,) * p.ndim and "model" in spec, n
            whole += 1
        else:
            assert ours[n] == spec, n
    assert any("model" in spec for spec in ours.values())
    assert whole == (4 if name.startswith("swin") else 0)


@pytest.mark.parametrize("case", list(VIT_CASES))
def test_sequence_parallel_equals_tensor_parallel(runs, case):
    """17 tokens over 2 ranks (9 and 8): both steps' logits and ranges
    and the losses equal the tensor-parallel step's bit for bit; the
    gradient within GRAD_RTOL (the LayerNorms' parts summed over the
    ranks); the parameters within the single-process bounds."""
    sp, tp = runs["two"][f"{case}-sp"], runs["two"][case]
    _assert_forward_equal(sp, tp[0], steps=(0, 1))
    assert [s["loss"] for s in sp[0]["steps"]] == [s["loss"] for s in tp[0]["steps"]]
    _assert_within_bounds(sp[0], runs["single"][case])


@pytest.mark.parametrize("case", list(WHOLE_CASES))
def test_sequence_parallel_runs_layers_the_axis_leaves_whole(runs, case):
    """3 heads at a model axis of 2 (and with it a 51-wide Mlp): each
    whole layer gathers the tokens before it, runs whole on both ranks and
    keeps the rank's tokens after it. Both steps' logits, ranges and
    losses equal the tensor-parallel step's, step 1's the single-process
    step's, tolerance 0; the gradient and parameters within the
    single-process bounds."""
    sp, tp = runs["two"][f"{case}-sp"], runs["two"][case]
    _assert_forward_equal(sp, tp[0], steps=(0, 1))
    _assert_forward_equal(sp, runs["single"][case])
    assert [s["loss"] for s in sp[0]["steps"]] == [s["loss"] for s in tp[0]["steps"]]
    _assert_within_bounds(sp[0], runs["single"][case])
    for name, p in sp[0]["params"].items():
        assert torch.equal(sp[1]["params"][name], p), name


@pytest.mark.parametrize("case", ["remat-tp", "remat-sp"])
def test_remat_composes_with_tensor_and_sequence_parallelism(runs, case):
    """``remat`` re-runs each block's collectives in the backward, its
    ranges held: everything equal to the same step without it,
    tolerance 0."""
    with_remat, without = runs["two"][case], runs["two"]["sm16-rowmax" + ("-sp" if case.endswith("sp") else "")]
    for a, b in zip(with_remat, without):
        _assert_forward_equal([a], b, steps=(0, 1))
        for key in ("grads", "params", "ema", "mu", "nu"):
            for name, t in b[key].items():
                assert torch.equal(a[key][name], t), (case, key, name)


def test_2x2_step1_equals_single_process(runs):
    """A (2, 2) mesh: the data rows' logits in order, every range on every
    rank and the eval step's logits equal the single-process step's,
    tolerance 0; the gradient and parameters within the bounds."""
    ranks = runs["four"]["2x2-tp"]
    _assert_forward_equal(ranks, runs["single"]["sm16-rowmax"], steps=(0, 1), data=2)
    for r in ranks:  # the eval step's logits, gathered over the data axis
        torch.testing.assert_close(r["eval_logits"], runs["single"]["sm16-rowmax"]["eval_logits"], rtol=0, atol=0)
    _assert_within_bounds(ranks[0], runs["single"]["sm16-rowmax"])


def test_zero1_with_tensor_parallelism_equals_tensor_parallelism(runs):
    """ZeRO-1 on the (2, 2) mesh, and with sequence parallelism and
    ``remat`` too, against the tensor-parallel step: logits, ranges,
    losses and the whole parameters, EMA and moments equal, tolerance 0
    (with sequence parallelism the forward; the rest within the
    single-process bounds)."""
    tp, z1, sp = (runs["four"][k] for k in ("2x2-tp", "2x2-zero1", "2x2-sp-zero1-remat"))
    for rank, (a, b) in enumerate(zip(tp, z1)):
        _assert_forward_equal([b], a, steps=(0, 1))
        for key in ("params", "ema", "mu", "nu"):
            for name, t in a[key].items():
                assert torch.equal(b[key][name], t), (rank, key, name)
    _assert_forward_equal(sp, runs["single"]["sm16-rowmax"], steps=(0, 1), data=2)
    _assert_within_bounds(sp[0], runs["single"]["sm16-rowmax"])


def _jax_key(name: str) -> str:
    return "['" + name.replace(".", "']['") + "']"


def test_zero1_with_tensor_parallelism_follows_jax_spec(runs):
    """On a (2, 2) mesh each leaf's spec equals JAX's ``zero1_shardings``
    spec for the same leaf of ``opt_state`` and ``ema_params``; each
    rank's moments have the shape that spec gives (halved on the model
    axis, then on the data axis)."""
    _, jstate = _jax_state()
    sh = jax_zero1_shardings(jstate, jax_make_mesh(2, 2, devices=jax.devices()[:4]))
    ndim = {jax.tree_util.keystr(k): a.ndim for k, a in jax.tree_util.tree_leaves_with_path(jstate.params)}
    theirs = {}
    for tree in (sh.opt_state[0].mu, sh.ema_params):
        for path, s in jax.tree_util.tree_leaves_with_path(tree):
            key = jax.tree_util.keystr(path)
            theirs.setdefault(key, set()).add(tuple(s.spec) + (None,) * (ndim[key] - len(s.spec)))
    model = create_model("deit_tiny", device="cpu", **VIT)
    ours = zero1_shardings(model, Mesh(2, 2, 0, "cpu", {}))
    both = 0
    for name, p in model.named_parameters():
        spec = ours[name]
        assert theirs[_jax_key(name)] == {spec}, name
        for r in runs["four"]["2x2-zero1"]:
            assert r["local_mu"][name] == tuple(d // 2 if ax else d for d, ax in zip(p.shape, spec)), name
        both += {"data", "model"} <= set(spec)
    assert both > 0


@pytest.mark.parametrize("case", ["jax-tp", "jax-sp", "jax-sp-heads3"], ids=["tp", "sp", "sp-heads3"])
def test_tp_step_matches_jax_sharded_step(runs, case):
    """The port's step on a model axis of 2 from JAX's init variables
    (drop path 0, no mixup) against JAX's jitted ``make_train_step`` with
    ``param_shardings`` on ``make_mesh(data=1, model=2)``, with
    ``seq_constraint`` for the sequence-parallel ones (the 3-head DeiT's
    attention whole on both ranks of the port, its qkv columns split by
    JAX's rules): parameters and EMA within JAX's own bounds for its
    sharded step, rtol 1e-4 and atol 2e-5 (``tests/test_zero1.py``). XLA's
    compiled rounding differs from the SIM ops run one by one
    (``ROADMAP.md`` §3 item 5), which these bounds cover."""
    mesh = jax_make_mesh(1, 2, devices=jax.devices()[:2])
    spec = runs["jax_specs"][case]
    jm, jstate = _jax_state(mesh if spec.get("seq") else None, spec["model_kw"])
    images, targets, _ = spec["batches"][0]
    step = jax.jit(jax_make_train_step(jm, ema_decay=0.99))
    js, _ = step(jax.device_put(jstate, jax_param_shardings(jstate, mesh)),
                 jax.device_put(jnp.asarray(images), jax_data_sharding(mesh)),
                 jax.device_put(jnp.asarray(targets), jax_data_sharding(mesh)), jax.random.PRNGKey(7))
    ours = runs["two"][case][0]
    for tree, key in ((js.params, "params"), (js.ema_params, "ema")):
        for path, a in jax.tree_util.tree_leaves_with_path(tree):
            name = jax.tree_util.keystr(path)[2:-2].replace("']['", ".")
            np.testing.assert_allclose(as_numpy(ours[key][name]), np.asarray(a), rtol=1e-4, atol=2e-5,
                                       err_msg=f"{key} {name}")


def test_uneven_token_blocks():
    """Ceil-sized blocks: 197 tokens over 2 ranks are 99 and 98, 17 over 4
    are 5, 5, 5 and 2; a split that leaves a rank none raises, and the
    even form still refuses what does not divide."""
    def bounds(size, n):
        return [Mesh(1, n, r, "cpu", {}).bounds(size, "model", even=False) for r in range(n)]

    assert bounds(197, 2) == [(0, 99), (99, 197)]
    assert bounds(17, 4) == [(0, 5), (5, 10), (10, 15), (15, 17)]
    x = torch.arange(17)
    assert torch.equal(torch.cat([Mesh(1, 4, r, "cpu", {}).block(x, "model", even=False) for r in range(4)]), x)
    with pytest.raises(ValueError, match="leave a rank"):
        bounds(5, 4)
    with pytest.raises(ValueError, match="not divisible by the model axis"):
        Mesh(1, 2, 0, "cpu", {}).block(x, "model")


def test_param_slices_cut_qkv_by_heads_as_serving_does():
    """Each rank's ``qkv`` columns are its heads' q, k and v columns, as
    ``shard_artifact`` cuts them for serving; ``proj`` rows, ``fc1``
    columns and ``fc2`` rows are contiguous blocks; a layer the axis does
    not divide (3 heads at 2) has none."""
    from ivit_tpu_torch.deploy import freeze_vit
    from ivit_tpu_torch.models.model_utils import model_variables

    model = create_model("deit_tiny", device="cpu", **VIT)
    art = freeze_vit(model, model_variables(model), "cpu")
    for m in range(2):
        d, pos = param_slices(model, Mesh(1, 2, m, "cpu", {}))["blocks_0.attn.qkv.kernel"]
        shard, _, _ = shard_artifact(art, 2, m)
        assert d == 1 and len(pos[m]) == 48
        np.testing.assert_array_equal(np.asarray(shard["blocks"][0]["qkv"]["w"]),
                                      np.asarray(art["blocks"][0]["qkv"]["w"])[:, pos[m].numpy()])
    slices = param_slices(model, Mesh(1, 2, 0, "cpu", {}))
    assert slices["blocks_0.attn.proj.kernel"][1][1].tolist() == list(range(16, 32))
    assert slices["blocks_0.mlp.fc1.kernel"][0] == 1 and slices["blocks_0.mlp.fc2.kernel"][0] == 0
    swin = create_model("swin_tiny", device="cpu", **dict(SWIN, embed_dim=24, num_heads=(3, 6)))
    names = param_slices(swin, Mesh(1, 2, 0, "cpu", {}))
    assert "layers_0_blocks_0.attn.qkv.kernel" not in names and "layers_0_blocks_0.mlp.fc1.kernel" in names
    assert "layers_1_blocks_0.attn.qkv.kernel" in names
