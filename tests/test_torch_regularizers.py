"""The lazy regularizers: the port's path-length and R1 losses and their
reg steps vs the JAX package's.

Tiny dims, batch 2, fp32, the same params, z and pl_noise on both sides.
The port hands the losses the frozen encoders' feature functions, so
they hoist the text features (deterministic, no gradients), as its reg
steps do; JAX's losses run the models' own
encoders. Bars: losses and pl_mean 1e-5 relative; after one reg step the
parameters lie within 2 lr_eff of JAX's with under 0.1% of entries more
than 1e-6 off, as in ``test_torch_train_step.py`` (Adam's first update is
lr * g / (|g| + eps) ~ +-lr, so a gradient within float noise of 0 may
flip its sign).
"""

import numpy as np
import pytest
import torch

import jax

from layoutdetr_tpu.models.discriminator import Discriminator as JaxDiscriminator
from layoutdetr_tpu.models.generator import Generator as JaxGenerator
from layoutdetr_tpu.training import loss as jax_loss
from layoutdetr_tpu.training import optimizers as jax_opt
from layoutdetr_tpu.training import train_step as jax_step
from layoutdetr_tpu_torch.models.generator import make_text_feature_fn
from layoutdetr_tpu_torch.ops import bias_act as bias_act_mod
from layoutdetr_tpu_torch.training.loss import LossWeights, d_r1_loss, g_pl_loss
from layoutdetr_tpu_torch.training.optimizers import build_optimizer
from layoutdetr_tpu_torch.training.train_step import (
    GANTrainState,
    make_d_reg_step,
    make_g_reg_step,
    make_train_step,
)
from layoutdetr_tpu_torch.utils.convert import (
    discriminator_state_dict_from_jax,
    generator_state_dict_from_jax,
)

from test_torch_common import one_torch_thread  # noqa: F401 (module-scoped autouse fixture)
from test_torch_train_step import B, LR_D, LR_G, N, _batch, _close_after_step, _model_kwargs, _torch

WEIGHTS = dict(pl_weight=2.0, r1_gamma=1.0)


@pytest.fixture(scope="module")
def case():
    from test_torch_common import random_params, tiny_configs

    jcfg, cfg = tiny_configs(reconst_decoder_layers=1, uncond_encoder_layers=1)
    batch = _batch(4)
    kw = _model_kwargs(batch)
    pg = random_params(JaxGenerator(jcfg), z=np.zeros((B, N, 4), np.float32),
                       bbox_real=batch["bboxes"], reconst=True, **kw, seed=2)
    pd = random_params(JaxDiscriminator(jcfg), bbox=batch["bboxes"], reconst=True, **kw, seed=3)
    return jcfg, cfg, batch, pg, pd


def _state(cfg, pg, pd):
    from layoutdetr_tpu_torch.models.discriminator import Discriminator
    from layoutdetr_tpu_torch.models.generator import Generator

    G, D = Generator(cfg), Discriminator(cfg)
    G.load_state_dict(generator_state_dict_from_jax(pg, cfg), strict=True)
    D.load_state_dict(discriminator_state_dict_from_jax(pd, cfg), strict=True)
    return GANTrainState.create(G.train(), D.train(), build_optimizer(G, reg_interval=4),
                                build_optimizer(D, reg_interval=16))


def _close(got, want, what):
    got = float(got.detach()) if isinstance(got, torch.Tensor) else float(got)
    assert abs(got - want) <= 1e-5 * max(abs(want), 1e-30), f"{what}: {got} vs {want}"


def test_pl_and_r1_losses_match_jax(case):
    jcfg, cfg, batch, pg, pd = case
    g, d = JaxGenerator(jcfg), JaxDiscriminator(jcfg)
    w = jax_loss.LossWeights(**WEIGHTS)
    z = np.random.default_rng(7).normal(size=(B, N, 4)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    shrink = B // 2
    noise = np.array(jax.random.normal(key, (shrink, N, 4)))
    pl_mean = 0.25

    loss, new_mean, stats = jax.jit(
        lambda p: jax_loss.g_pl_loss(g.apply, {"params": p}, batch, z, {"pl_noise": key}, w,
                                     pl_mean))(pg)
    r1, r1_stats = jax.jit(lambda p: jax_loss.d_r1_loss(d.apply, {"params": p}, batch, None, w))(pd)

    state = _state(cfg, pg, pd)
    tb = _torch(batch)
    got, got_mean, got_stats = g_pl_loss(
        state.G, tb, LossWeights(**WEIGHTS), torch.tensor(pl_mean), torch.from_numpy(z),
        torch.from_numpy(noise), text_feature_fn=make_text_feature_fn(state.G.text_encoder))
    _close(got, float(loss), "pl loss")
    _close(got_mean, float(new_mean), "pl_mean")
    _close(got_stats["Loss/pl_penalty"], float(stats["Loss/pl_penalty"]), "pl_penalty")
    assert got.requires_grad and float(loss) > 0

    got_r1, got_r1_stats = d_r1_loss(state.D, tb, LossWeights(**WEIGHTS),
                                     text_feature_fn=make_text_feature_fn(state.D.text_encoder))
    _close(got_r1, float(r1), "r1 loss")
    _close(got_r1_stats["Loss/r1_penalty"], float(r1_stats["Loss/r1_penalty"]), "r1_penalty")
    assert got_r1.requires_grad and float(r1) > 0

    # without hoisted features the models' own (grad-enabled) encoders run
    own, _, _ = g_pl_loss(state.G, tb, LossWeights(**WEIGHTS), torch.tensor(pl_mean),
                          torch.from_numpy(z), torch.from_numpy(noise))
    _close(own, float(loss), "pl loss, G's own encoder")


def _jax_reg_state(jcfg, pg, pd):
    vg, vd = {"params": pg}, {"params": pd}
    tx_g = jax_opt.build_optimizer(vg, reg_interval=4, frozen_substrings=jax_opt.G_FROZEN_SUBSTRINGS)
    tx_d = jax_opt.build_optimizer(vd, reg_interval=16, frozen_substrings=jax_opt.D_FROZEN_SUBSTRINGS)
    return jax_step.GANTrainState.create(vg, vd, tx_g, tx_d), tx_g, tx_d


@pytest.mark.parametrize("which", ["g_reg", "d_reg"])
def test_reg_steps_match_jax(case, which):
    jcfg, cfg, batch, pg, pd = case
    jstate, tx_g, tx_d = _jax_reg_state(jcfg, pg, pd)
    w = jax_loss.LossWeights(**WEIGHTS)
    rng = jax.random.PRNGKey(9)
    state = _state(cfg, pg, pd)
    if which == "g_reg":
        jfn = jax_step.make_g_reg_step(JaxGenerator(jcfg).apply, tx_g, w, z_dim=4, max_elements=N,
                                       gain=4.0)
        rng_z, rng_n = jax.random.split(rng)
        z = torch.from_numpy(np.asarray(jax.random.normal(rng_z, (B, N, 4))))
        noise = torch.from_numpy(np.asarray(jax.random.normal(rng_n, (B // 2, N, 4))))
        stats = make_g_reg_step(LossWeights(**WEIGHTS), z_dim=4, max_elements=N, gain=4.0)(
            state, _torch(batch), torch.Generator(), z=z, pl_noise=noise)
    else:
        jfn = jax_step.make_d_reg_step(JaxDiscriminator(jcfg).apply, tx_d, w, gain=16.0)
        stats = make_d_reg_step(LossWeights(**WEIGHTS), gain=16.0)(state, _torch(batch))
    new, jstats = jax.jit(jfn)(jstate, batch, rng)
    assert set(stats) == set(jstats)
    for k, v in jstats.items():
        _close(stats[k], float(v), k)
    _close(state.pl_mean, float(new.pl_mean), "pl_mean")
    if which == "g_reg":
        assert float(new.pl_mean) > 0
        pairs = (("g", state.G.state_dict(), generator_state_dict_from_jax, new.params_g, LR_G),
                 ("d", state.D.state_dict(), discriminator_state_dict_from_jax, new.params_d, LR_D))
    else:
        pairs = (("d", state.D.state_dict(), discriminator_state_dict_from_jax, new.params_d, LR_D),
                 ("g", state.G.state_dict(), generator_state_dict_from_jax, new.params_g, LR_G))
    (name, got_sd, to_sd, params, lr), (_, other_sd, other_to_sd, other_params, _) = pairs
    want = to_sd(jax.tree.map(np.asarray, params), cfg)
    _close_after_step(got_sd, want, lr, f"{which} params_{name}")
    before = to_sd({"g": pg, "d": pd}[name], cfg)
    moved = max(float((got_sd[k] - before[k]).abs().max()) for k in before)
    assert moved > 0.5 * lr  # the step moved the regularized model
    untouched = other_to_sd(jax.tree.map(np.asarray, other_params), cfg)
    assert all(torch.equal(other_sd[k], untouched[k]) for k in untouched)


def test_r1_never_reaches_bias_act(case, monkeypatch):
    """R1 calls D at reconst=False, which never runs the bg_decoder: no
    bias_act call (its Function is once-differentiable)."""
    _, cfg, batch, pg, pd = case
    calls = []
    real = bias_act_mod.bias_act_ref

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(bias_act_mod, "bias_act_ref", counted)
    state = _state(cfg, pg, pd)
    make_d_reg_step(LossWeights(**WEIGHTS))(state, _torch(batch))
    assert calls == []
    tb = _torch(batch)
    with torch.no_grad():  # the counter sees the bg_decoder's calls
        state.D(tb["bboxes"], reconst=True, **{k: tb[k] for k in ("text_ids", "text_mask", "text_len",
                                                                  "background")},
                bbox_class=tb["labels"], padding_mask=~tb["mask"])
    assert len(calls) > 0


def test_main_step_with_aug_p0_matches_no_aug(case):
    """aug_p = 0 fires no augmentation: the deterministic step with fixed z
    gives the same stats and parameters as the step without aug_p; aug_p = 1
    changes D's losses and not G's reconstruction terms."""
    _, cfg, batch, pg, pd = case
    z = tuple(torch.from_numpy(np.random.default_rng(s).normal(size=(B, N, 4)).astype(np.float32))
              for s in (1, 2))
    runs = []
    for aug_p in (None, 0.0, 1.0):
        state = _state(cfg, pg, pd)
        tb = _torch(batch)
        if aug_p is not None:
            tb["aug_p"] = aug_p
        step = make_train_step(batch_size=B, z_dim=4, max_elements=N, deterministic=True)
        stats = step(state, tb, torch.Generator().manual_seed(0), z=z)
        runs.append(({k: float(v) for k, v in stats.items()}, state.G.state_dict(), state.D.state_dict()))
    (s0, g0, d0), (s1, g1, d1), (s2, _, _) = runs
    assert s0 == s1
    assert all(torch.equal(g0[k], g1[k]) for k in g0) and all(torch.equal(d0[k], d1[k]) for k in d0)
    assert s2["Loss/D/loss_Dreal"] != s0["Loss/D/loss_Dreal"]
    assert s2["Loss/G/loss_Ggen_bbox_rec"] == s0["Loss/G/loss_Ggen_bbox_rec"]
