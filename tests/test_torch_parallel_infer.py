"""The port's data- and tensor-parallel serving (``ivit_tpu_torch.parallel``)
against its single-process engine and against JAX's sharded engines, on
CPU ranks over ``gloo``; logits with tolerance 0.

Tiny seeded artifacts: a DeiT (4 heads, depth 2, 10 classes, so the
head's 5-column shard at ``model = 2`` is carried zero-padded to 8 with
its true width ``n``) at sm8 with the stable GELU and at sm16 with the
row-max GELU, and a Swin whose stage-1 single head does not divide a
model axis of 2 (that stage's attention runs replicated; its stage-2
heads split). The ranks run in ``torch_parallel_worker`` processes,
spawned once per world: worlds of 2 (``(2, 1)`` data-parallel,
``(1, 2)`` tensor-parallel) and of 4 (``(2, 2)``). The JAX side runs on
the conftest's 8-device CPU mesh with ``use_pallas=False``.

The port's qkv shard is a rank's heads' q, k and v columns; JAX's
``P(None, "model")`` shard is a contiguous column block of the same
shape (GSPMD reshards before the head split). Where a layer's heads do
not divide the model axis the port replicates the layer, and JAX's shard
shapes differ from the port's there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivit_tpu.deploy import build_vit_infer as jax_build_vit_infer
from ivit_tpu.deploy.swin_engine import build_swin_infer as jax_build_swin_infer
from ivit_tpu.parallel import make_mesh as jax_make_mesh
from ivit_tpu.parallel import shard_infer as jax_shard_infer
from ivit_tpu.parallel import shard_infer_tp as jax_shard_infer_tp
from ivit_tpu.parallel import tp_infer as jax_tp_infer
from ivit_tpu.parallel import tp_weight_shardings as jax_tp_weight_shardings
from ivit_tpu_torch.deploy import build_swin_infer, build_vit_infer
from ivit_tpu_torch.deploy.swin_synthetic import synthetic_swin_artifact
from ivit_tpu_torch.deploy.synthetic import synthetic_vit_artifact
from ivit_tpu_torch.parallel import Mesh, shard_infer, shard_infer_tp, tp_weight_shardings
from ivit_tpu_torch.parallel.tp_infer import shard_artifact

from torch_parallel_worker import run_ranks, serve
from tests.torch_threads import one_torch_thread  # noqa: F401

VIT = dict(img_size=16, patch_size=8, embed_dim=32, depth=2, num_heads=4, num_classes=10)
SWIN = dict(img_size=16, patch_size=2, embed_dim=16, depths=(2, 2), num_heads=(1, 2), window_size=4, num_classes=8)
ROUTE_B = ("layernorm", "softmax", "gelu")
IMAGES = np.random.default_rng(7).standard_normal((4, 16, 16, 3)).astype(np.float32)


def _artifacts():
    return {
        "vit8": synthetic_vit_artifact("deit_tiny", seed=1, softmax_bits=8, gelu_stable=True, **VIT),
        "vit16": synthetic_vit_artifact("deit_tiny", seed=2, softmax_bits=16, gelu_stable=False, **VIT),
        "swin": synthetic_swin_artifact("swin_tiny", seed=3, **SWIN),
    }


ARTIFACTS = _artifacts()

# (id, artifact, route, mesh, kernels, opts): every case runs on every rank
CASES = {
    2: [
        ("vit8-dp", "vit8", "dp", (2, 1), ("attention", "layernorm"), {}),
        ("vit8-tp", "vit8", "tp", (1, 2), ("attention", "layernorm"), {}),
        ("vit8-tp-strict", "vit8", "tp", (1, 2), (), {"strict_dyadic": True}),
        ("vit16-tp-plain", "vit16", "tp", (1, 2), (), {}),
        ("vit16-tp-routeB", "vit16", "tp", (1, 2), ROUTE_B, {}),
        ("vit16-dp-routeB", "vit16", "dp", (2, 1), ROUTE_B, {}),
        ("swin-dp", "swin", "dp", (2, 1), ("attention", "layernorm"), {}),
        ("swin-tp", "swin", "tp", (1, 2), ("attention", "layernorm"), {}),
    ],
    4: [
        ("vit8-dp-tp", "vit8", "tp", (2, 2), ("attention", "layernorm"), {}),
        ("vit16-dp-tp-routeB", "vit16", "tp", (2, 2), ROUTE_B, {}),
        ("swin-dp-tp", "swin", "tp", (2, 2), ("attention", "layernorm"), {}),
    ],
}
IDS = [(w, i) for w, cases in CASES.items() for i in range(len(cases))]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Each world's ranks' results, one spawn a world."""
    out = {}
    for world, cases in CASES.items():
        specs = [{"family": "swin" if a == "swin" else "vit", "route": route, "mesh": mesh, "kernels": kernels,
                  "opts": opts, "artifact": ARTIFACTS[a], "images": IMAGES}
                 for _, a, route, mesh, kernels, opts in cases]
        out[world] = run_ranks(world, tmp_path_factory.mktemp(f"world{world}"), serve, specs)
    return out


def _jax_logits(name, route, mesh_shape, opts):
    art = ARTIFACTS[name]
    kw = {"use_pallas": False}
    if name == "vit16":
        kw["attn_v_mode"] = "exact"
    kw.update(opts)
    build = jax_build_swin_infer if name == "swin" else jax_build_vit_infer
    mesh = jax_make_mesh(*mesh_shape, devices=jax.devices()[: mesh_shape[0] * mesh_shape[1]])
    if route == "dp":
        fn = jax_shard_infer(build(art, **kw), mesh)
    else:
        fn = jax_shard_infer_tp(art, mesh, build_fn=build, **kw)
    return np.asarray(fn(jnp.asarray(IMAGES)))


@pytest.mark.parametrize("world,index", IDS, ids=[CASES[w][i][0] for w, i in IDS])
def test_sharded_logits_equal_single_process_and_jax(served, world, index):
    """Every rank's logits equal the port's single-process engine on the
    same kernels and JAX's sharded engine on the same mesh shape, with
    tolerance 0."""
    _, name, route, mesh, kernels, opts = CASES[world][index]
    build = build_swin_infer if name == "swin" else build_vit_infer
    single = build(ARTIFACTS[name], "cpu", kernels=kernels, **opts)(torch.from_numpy(IMAGES)).numpy()
    for rank, results in enumerate(served[world]):
        np.testing.assert_array_equal(results[index]["logits"], single, err_msg=f"rank {rank}")
    np.testing.assert_array_equal(single, _jax_logits(name, route, mesh, opts))


def _jax_shard_shapes(art: dict, n_model: int) -> dict:
    """JAX's per-device shard shape of every weight its TP rules name,
    by path."""
    paths: list = []
    jax_tp_infer._extract(art, "", paths)
    _, weights, shardings = jax_tp_weight_shardings(art, jax_make_mesh(1, n_model, devices=jax.devices()[:n_model]))
    return {p: tuple(sh.shard_shape(w.shape)) for (p, _), w, sh in zip(paths, weights, shardings)}


@pytest.mark.parametrize("name,replicated", [("vit8", 0), ("swin", 6)])
def test_per_rank_weight_shapes(served, name, replicated):
    """The weights each rank carries at ``model = 2`` have the shapes of
    the port's ``tp_weight_shardings``; those equal JAX's shard shapes
    wherever the heads divide. Swin's stage 1 (one head) is replicated
    by the port, while JAX shards its qkv weight and bias and its proj
    weight in both blocks: 6 leaves differ. The DeiT's 10-class head
    shard (32, 5) is carried zero-padded to (32, 8) with ``n = 5``."""
    index = next(i for i, c in enumerate(CASES[2]) if c[1] == name and c[3] == (1, 2))
    ours, theirs = tp_weight_shardings(ARTIFACTS[name], 2), _jax_shard_shapes(ARTIFACTS[name], 2)
    assert set(ours) == set(theirs)
    differ = {p for p, (spec, shape) in ours.items() if shape != theirs[p]}
    assert len(differ) == replicated and all(ours[p][0] == () for p in differ), differ
    for rank, results in enumerate(served[2]):
        carried = results[index]["shapes"]
        for path, (_, shape) in ours.items():
            if path.endswith("/w"):
                assert carried[path] == shape, (rank, path)
        if name == "vit8":
            assert carried["head/w"] == (32, 5) and carried["head/w:padded"] == (32, 8)


def test_qkv_shard_holds_its_heads_columns():
    """Rank m's qkv shard is the q, k and v columns of heads
    [m·H/n, (m+1)·H/n), with the same entries of the bias and the output
    scale, not the contiguous column block JAX's spec names; proj's rows
    and the relative-position bias follow the same heads."""
    for name in ("vit8", "swin"):
        art = ARTIFACTS[name]
        blk = art["blocks"][0] if name == "vit8" else art["stages"][1]["blocks"][1]
        heads = art["config"]["num_heads"] if name == "vit8" else blk["heads"]
        C = blk["qkv"]["w"].shape[0]
        hd, hl = C // heads, heads // 2
        for m in range(2):
            shard, infos, _ = shard_artifact(art, 2, m)
            got = shard["blocks"][0] if name == "vit8" else shard["stages"][1]["blocks"][1]
            cols = [t * C + h * hd + j for t in range(3) for h in range(m * hl, (m + 1) * hl) for j in range(hd)]
            for leaf in ("w", "b", "out_scale"):
                np.testing.assert_array_equal(got["qkv"][leaf], np.asarray(blk["qkv"][leaf])[..., cols])
            np.testing.assert_array_equal(got["proj"]["w"], blk["proj"]["w"][m * hl * hd:(m + 1) * hl * hd])
            if name == "swin":
                np.testing.assert_array_equal(got["bias_req"], blk["bias_req"][m * hl:(m + 1) * hl])
        assert cols != list(range(3 * C // 2, 3 * C))


def test_k4_under_a_model_axis_raises():
    """K4 fuses the fc1 GEMM with a row max a column shard cannot see:
    ``linear_gelu`` under ``model > 1`` raises at build time; at
    ``model = 1`` it builds."""
    with pytest.raises(ValueError, match="linear_gelu"):
        shard_infer_tp(ARTIFACTS["vit16"], Mesh(1, 2, 0, "cpu", {}), kernels=("layernorm", "linear_gelu"))
    infer = shard_infer_tp(ARTIFACTS["vit16"], Mesh(1, 1, 0, "cpu", {}), kernels=("layernorm", "linear_gelu"))
    assert "linear_gelu" in infer.kernels


def test_indivisible_batch_raises():
    """A global batch the data axis does not divide raises, in both
    forms of serving."""
    x = torch.from_numpy(IMAGES[:3])
    dp = shard_infer(build_vit_infer(ARTIFACTS["vit8"], "cpu"), Mesh(2, 1, 0, "cpu", {}))
    tp = shard_infer_tp(ARTIFACTS["vit8"], Mesh(2, 1, 0, "cpu", {}))
    for fn in (dp, tp):
        with pytest.raises(ValueError, match="not divisible by the data axis"):
            fn(x)
