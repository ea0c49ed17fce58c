"""The port's mixup/cutmix against ``ivit_tpu/train/augment.py`` on the
CPU, given the same draws.

JAX's ``jax.random`` streams cannot be reproduced in torch, so each case
recomputes the draws JAX made from its key splits and hands them to the
port's arithmetic (``train.augment.apply_mixup``); JAX's function runs
eagerly, op by op.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivit_tpu.train.augment import MixupConfig as JaxMixupConfig
from ivit_tpu.train.augment import mixup_cutmix as jax_mixup_cutmix
from ivit_tpu_torch.train import MixupConfig, mixup_cutmix
from ivit_tpu_torch.train.augment import MixupDraws, apply_mixup, cutmix_box, draw_mixup
from tests.torch_threads import one_torch_thread  # noqa: F401


def _jax_draws(key, cfg, h, w):
    """JAX's draws inside ``mixup_cutmix(key, ...)``, from its key splits."""
    k_lam, k_switch, k_box, k_lam2 = jax.random.split(key, 4)
    ky, kx = jax.random.split(k_box)
    return MixupDraws(
        lam_mix=float(jax.random.beta(k_lam, cfg.mixup_alpha, cfg.mixup_alpha)),
        use_cutmix=bool(jax.random.bernoulli(k_switch, cfg.switch_prob)),
        cy=int(jax.random.randint(ky, (), 0, h)),
        cx=int(jax.random.randint(kx, (), 0, w)),
        lam_cut=float(jax.random.beta(k_lam2, cfg.cutmix_alpha, cfg.cutmix_alpha)),
    )


def _is_case(draws, case, h, w):
    if case == "mixup":
        return not draws.use_cutmix
    if not draws.use_cutmix:
        return False
    y0, y1, x0, x1 = cutmix_box(h, w, draws.cy, draws.cx, draws.lam_cut)
    cut = np.sqrt(np.float32(1.0) - np.float32(draws.lam_cut))
    clipped = (y1 - y0, x1 - x0) != (int(np.float32(h) * cut) // 2 * 2, int(np.float32(w) * cut) // 2 * 2)
    return clipped == (case == "cutmix-clipped") and y1 > y0 and x1 > x0


@pytest.mark.parametrize("case", ["mixup", "cutmix", "cutmix-clipped"])
def test_mixup_cutmix_matches_jax(case):
    """Given the draws JAX made (recomputed from its key splits; the first
    key of 0, 1, ... whose draws take the branch), the images and soft
    targets equal ``ivit_tpu/train/augment.py:mixup_cutmix``'s bit for
    bit: the mixup branch, a cutmix box inside the image, and one the
    image edge clips, so that the realized λ differs from the drawn one."""
    n, h, w = 6, 12, 10
    rng = np.random.default_rng(5)
    images = rng.standard_normal((n, h, w, 3)).astype(np.float32)
    labels = rng.integers(0, 10, n).astype(np.int32)
    jcfg = JaxMixupConfig(num_classes=10)
    cfg = MixupConfig(num_classes=10)
    assert tuple(cfg) == tuple(jcfg)
    key = next(k for k in map(jax.random.PRNGKey, range(200)) if _is_case(_jax_draws(k, cfg, h, w), case, h, w))
    draws = _jax_draws(key, cfg, h, w)
    j_img, j_tgt = jax_mixup_cutmix(key, jnp.asarray(images), jnp.asarray(labels), jcfg)
    t_img, t_tgt = apply_mixup(torch.from_numpy(images), torch.from_numpy(labels), cfg, draws)
    np.testing.assert_array_equal(t_img.numpy(), np.asarray(j_img))
    np.testing.assert_array_equal(t_tgt.numpy(), np.asarray(j_tgt))


def test_mixup_cutmix_draws_are_seeded():
    """The entry point on the CPU: one seed, one batch; targets are rows
    of probabilities; both branches come up over a few batches."""
    cfg = MixupConfig(num_classes=10)
    images = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 8, 8, 3)).astype(np.float32))
    labels = torch.tensor([0, 3, 9, 3])
    a = mixup_cutmix(images, labels, cfg, np.random.default_rng(7), device="cpu")
    b = mixup_cutmix(images, labels, cfg, np.random.default_rng(7), device="cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[1].shape == (4, 10) and torch.allclose(a[1].sum(-1), torch.ones(4))
    gen = np.random.default_rng(1)
    assert {draw_mixup(cfg, 8, 8, gen).use_cutmix for _ in range(20)} == {False, True}
