"""The whole slice: the port's GAN train step vs the JAX package's.

Tiny dims (TINY_KW, one reconstruction-decoder and unconditional layer),
batch 2, fp32, deterministic (no dropout: the two frameworks' dropout
bits differ), the same z handed to both, the text pass hoisted and
shared (JAX's with flash=False). Bars:

- loss values 1e-5 max-abs, relative above 1 (the Gmain total is ~170,
  where one fp32 ulp is 1.5e-5); gradients 1e-5 of each leaf's max |g|
  (rounding of the same fp32 arithmetic in another order). A leaf whose
  true gradient is 0 holds rounding noise on both sides (the attention
  key biases: softmax ignores a constant per query row), so a leaf's
  scale is at least 1e-3 of the phase's largest |g|;
- after one step, stats 1e-5 relative; parameters within 2 * lr_eff of
  JAX's (lr_eff = 8e-6 for G, 9.4e-6 for D): with beta1 = 0 Adam's first
  update is lr * g / (|g| + eps) ~ +-lr, so a gradient within float noise
  of 0 may flip its sign. Entries more than 1e-6 off must be under 0.1%.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from layoutdetr_tpu.models.discriminator import Discriminator as JaxDiscriminator
from layoutdetr_tpu.models.generator import Generator as JaxGenerator
from layoutdetr_tpu.models.generator import make_text_feature_fn as jax_text_feature_fn
from layoutdetr_tpu.training import loss as jax_loss
from layoutdetr_tpu.training import optimizers as jax_opt
from layoutdetr_tpu.training import train_step as jax_step
from layoutdetr_tpu_torch.models.discriminator import Discriminator
from layoutdetr_tpu_torch.models.generator import Generator
from layoutdetr_tpu_torch.training.loss import LossWeights, d_main_loss, g_main_loss
from layoutdetr_tpu_torch.training.optimizers import build_optimizer
from layoutdetr_tpu_torch.training.train_step import (
    GANTrainState,
    _sanitize,
    ema_beta,
    make_train_step,
)
from layoutdetr_tpu_torch.utils.convert import (
    discriminator_state_dict_from_jax,
    generator_state_dict_from_jax,
)

from test_torch_common import assert_max_abs, random_params, tiny_configs
from test_torch_common import one_torch_thread  # noqa: F401 (module-scoped autouse fixture)

B, N, T = 2, 9, 16
LR_G = 1e-5 * 4 / 5
LR_D = 1e-5 * 16 / 17


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, N, T), np.int32)
    lens = rng.integers(2, T + 1, size=(B, N))
    mask[np.arange(T)[None, None, :] >= lens[..., None]] = 0
    pad = np.zeros((B, N), bool)
    pad[0, 5:] = True
    pad[1, 8:] = True
    return dict(
        bboxes=rng.uniform(0.1, 0.9, (B, N, 4)).astype(np.float32),
        labels=rng.integers(0, 8, (B, N)),
        text_ids=rng.integers(1, 64, (B, N, T)) * mask,
        text_mask=mask,
        text_len=rng.integers(0, 30, (B, N)),
        mask=~pad,
        background=rng.normal(size=(B, 32, 32, 3)).astype(np.float32),
    )


def _model_kwargs(batch):
    return dict(bbox_class=batch["labels"], text_ids=batch["text_ids"],
                text_mask=batch["text_mask"], text_len=batch["text_len"],
                padding_mask=~batch["mask"], background=batch["background"])


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _jax_z(rng):
    """The z JAX's step draws for one phase (train_step.py:171-194, grad_accum 1)."""
    rng, _ = jax.random.split(rng)  # the text-pass split
    rng_z, _ = jax.random.split(rng)
    return np.asarray(jax.random.normal(rng_z, (B, N, 4)))


@pytest.fixture(scope="module")
def case():
    jcfg, cfg = tiny_configs(reconst_decoder_layers=1, uncond_encoder_layers=1)
    batch = _batch()
    kw = _model_kwargs(batch)
    pg = random_params(JaxGenerator(jcfg), z=np.zeros((B, N, 4), np.float32),
                       bbox_real=batch["bboxes"], reconst=True, **kw)
    pd = random_params(JaxDiscriminator(jcfg), bbox=batch["bboxes"], reconst=True, **kw, seed=1)
    return jcfg, cfg, batch, pg, pd


def _port_models(cfg, pg, pd):
    G, D = Generator(cfg), Discriminator(cfg)
    G.load_state_dict(generator_state_dict_from_jax(pg, cfg), strict=True)
    D.load_state_dict(discriminator_state_dict_from_jax(pd, cfg), strict=True)
    return G.train(), D.train()


def _assert_grads(module, grads, want_sd, what):
    """Each trainable parameter's gradient vs JAX's (carried to port names
    by the converter), to 1e-5 of the leaf's max |g| (at least 1e-3 of
    the phase's largest)."""
    floor = 1e-3 * max(float(v.abs().max()) for v in want_sd.values())
    checked = 0
    for (name, p), g in zip([(n, p) for n, p in module.named_parameters() if p.requires_grad],
                            grads):
        if g is None:  # never used: the text decoder's crossattention
            assert ".crossattention." in name, f"{what}: no gradient for {name}"
            continue
        want = want_sd[name].numpy()
        scale = max(float(np.abs(want).max()), floor)
        err = float(np.abs(g.numpy() - want).max())
        assert err <= 1e-5 * scale, f"{what} grad {name}: {err:.3e} > 1e-5 x {scale:.3e}"
        checked += 1
    assert checked > 50


@pytest.mark.parametrize("phase", ["g_main", "d_main"])
def test_loss_values_and_grads_match_jax(case, phase):
    jcfg, cfg, batch, pg, pd = case
    g, d = JaxGenerator(jcfg), JaxDiscriminator(jcfg)
    z = np.random.default_rng(5).normal(size=(B, N, 4)).astype(np.float32)
    tf = np.asarray(jax_text_feature_fn(jcfg, flash=False)(
        pg["text_encoder"], batch["text_ids"], batch["text_mask"]))
    jbatch = dict(batch, text_feat_g=tf, text_feat_d=tf)
    w = jax_loss.LossWeights()
    vg = {"g_main": jax_loss.g_main_loss, "d_main": jax_loss.d_main_loss}[phase]

    if phase == "g_main":
        fn = lambda p: vg(g.apply, d.apply, {"params": p}, {"params": pd}, jbatch, z, None, w, True)
        params, to_sd = pg, generator_state_dict_from_jax
    else:
        fn = lambda p: vg(g.apply, d.apply, {"params": pg}, {"params": p}, jbatch, z, None, w, True)
        params, to_sd = pd, discriminator_state_dict_from_jax
    (total, stats), grads = jax.jit(jax.value_and_grad(fn, has_aux=True))(params)

    G, D = _port_models(cfg, pg, pd)
    build_optimizer(G)
    build_optimizer(D)  # freezes the frozen set
    tb = _torch(jbatch)
    port_fn = {"g_main": g_main_loss, "d_main": d_main_loss}[phase]
    got_total, got_stats = port_fn(G, D, tb, torch.from_numpy(z), LossWeights(), True)
    assert set(got_stats) == set(stats)
    for k, v in [("total", total), *stats.items()]:
        got = got_total if k == "total" else got_stats[k]
        assert_max_abs(got, np.asarray(v), 1e-5 * max(1.0, abs(float(v))), f"{phase} {k}")

    module = G if phase == "g_main" else D
    params_t = [p for p in module.parameters() if p.requires_grad]
    got_grads = torch.autograd.grad(got_total, params_t, allow_unused=True)
    want_sd = to_sd(jax.tree.map(np.asarray, grads), cfg)
    _assert_grads(module, got_grads, want_sd, phase)


def _close_after_step(got_sd, want_sd, lr, what):
    """Parameters after one Adam step: within 2 lr of JAX's; entries more
    than 1e-6 off under 0.1%."""
    n_total = n_off = 0
    worst = 0.0
    for name, want in want_sd.items():
        if ".crossattention." in name:  # filled by the converter, never trained
            continue
        diff = np.abs(got_sd[name].float().numpy() - want.numpy())
        worst = max(worst, float(diff.max(initial=0.0)))
        n_total += diff.size
        n_off += int((diff > 1e-6).sum())
    assert worst <= 2 * lr, f"{what}: max-abs {worst:.3e} > 2 x lr_eff {lr:.2e}"
    assert n_off <= 1e-3 * n_total, f"{what}: {n_off} of {n_total} entries off by > 1e-6"
    return worst, n_off, n_total


@pytest.fixture(scope="module")
def stepped(case):
    jcfg, cfg, batch, pg, pd = case
    g, d = JaxGenerator(jcfg), JaxDiscriminator(jcfg)
    vg, vd = {"params": pg}, {"params": pd}
    tx_g = jax_opt.build_optimizer(vg, reg_interval=4, frozen_substrings=jax_opt.G_FROZEN_SUBSTRINGS)
    tx_d = jax_opt.build_optimizer(vd, reg_interval=16, frozen_substrings=jax_opt.D_FROZEN_SUBSTRINGS)
    state = jax_step.GANTrainState.create(vg, vd, tx_g, tx_d)
    step = jax_step.make_train_step(
        g.apply, d.apply, tx_g, tx_d, batch_size=B, z_dim=4, max_elements=N, deterministic=True,
        text_feature_fn=jax_text_feature_fn(jcfg, flash=False), share_text_encoder=True,
        ema_freeze_labels=jax_opt.freeze_mask(vg, jax_opt.G_FROZEN_SUBSTRINGS))
    rng = jax.random.PRNGKey(1)
    new, stats = jax.jit(step)(state, batch, rng)
    rng_g, rng_d = jax.random.split(rng)
    z = (_jax_z(rng_g), _jax_z(rng_d))
    want = dict(stats={k: float(v) for k, v in stats.items()},
                g=generator_state_dict_from_jax(jax.tree.map(np.asarray, new.params_g), cfg),
                d=discriminator_state_dict_from_jax(jax.tree.map(np.asarray, new.params_d), cfg),
                gema=generator_state_dict_from_jax(jax.tree.map(np.asarray, new.params_gema), cfg))

    G, D = _port_models(cfg, pg, pd)
    before = {k: v.clone() for k, v in G.state_dict().items()}
    opt_g, opt_d = build_optimizer(G, reg_interval=4), build_optimizer(D, reg_interval=16)
    pstate = GANTrainState.create(G, D, opt_g, opt_d)
    port_step = make_train_step(batch_size=B, z_dim=4, max_elements=N, deterministic=True)
    got_stats = port_step(pstate, _torch(batch), torch.Generator().manual_seed(0),
                          z=tuple(torch.from_numpy(np.array(x)) for x in z))
    return want, pstate, got_stats, before


def test_train_step_matches_jax(stepped):
    want, state, got_stats, _ = stepped
    assert state.step == 1 and set(got_stats) == set(want["stats"])
    for k, v in want["stats"].items():
        err = abs(float(got_stats[k]) - v)
        assert err <= 1e-5 * max(abs(v), 1.0), f"stat {k}: {float(got_stats[k])} vs {v}"
    for what, got_sd, lr in (("g", state.G.state_dict(), LR_G), ("d", state.D.state_dict(), LR_D),
                             ("gema", state.G_ema.state_dict(), LR_G)):
        worst, n_off, n = _close_after_step(got_sd, want[what], lr, f"params_{what}")
        print(f"params_{what} after one step: max-abs {worst:.3e}, {n_off} of {n} off by > 1e-6")


def test_frozen_parameters_do_not_move(stepped):
    _, state, _, before = stepped
    after = state.G.state_dict()
    moved = {k for k in before if not torch.equal(before[k], after[k])}
    frozen = {k for k in before if k.startswith(("text_encoder.", "backbone.0.body.conv1.",
                                                 "backbone.0.body.bn1.", "backbone.0.body.layer1."))}
    assert frozen and not frozen & moved
    assert any(k.startswith("transformer.") for k in moved)
    assert any(k.startswith("text_decoder.") for k in moved)
    for name, p in state.G.named_parameters():
        assert p.requires_grad == (name not in frozen), name


def test_ema_beta_and_sanitize_match_jax():
    for cur in (16.0, 800.0, 1e6):
        got = ema_beta(16, 5.0, cur)
        want = float(jax_step.ema_beta(16, 5.0, cur))
        assert abs(got - want) <= 1e-6 * want, (cur, got, want)
    want = float(jax_step.ema_beta(16, 5.0, 32.0, None))  # fp32 in JAX, a double here
    assert abs(ema_beta(16, 5.0, 32.0, ema_rampup=None) - want) <= 1e-6 * want
    g = np.array([1.0, np.nan, np.inf, -np.inf, -2.0], np.float32)
    t = torch.from_numpy(g.copy())
    _sanitize([t, None])
    np.testing.assert_array_equal(t.numpy(), np.asarray(jax_step._sanitize(g)))


def test_grad_accum_averages_microbatches(case):
    """Two identical halves: the mean of the two microbatch gradients is
    the whole batch's gradient, so the steps agree."""
    _, cfg, batch, pg, pd = case
    dup = {k: np.concatenate([v[:1], v[:1]]) for k, v in batch.items()}
    z = torch.from_numpy(np.random.default_rng(3).normal(size=(1, N, 4)).astype(np.float32))
    results = []
    for accum in (1, 2):
        G, D = _port_models(cfg, pg, pd)
        state = GANTrainState.create(G, D, build_optimizer(G, reg_interval=4),
                                     build_optimizer(D, reg_interval=16))
        step = make_train_step(batch_size=B, z_dim=4, max_elements=N, deterministic=True,
                               grad_accum=accum)
        stats = step(state, _torch(dup), torch.Generator().manual_seed(0),
                     z=(torch.cat([z, z]), torch.cat([z, z])))
        results.append((stats, state.G.state_dict(), state.D.state_dict()))
    (s1, g1, d1), (s2, g2, d2) = results
    for k in s1:
        assert abs(float(s1[k]) - float(s2[k])) <= 1e-5 * max(abs(float(s1[k])), 1.0), k
    for a, b in ((g1, g2), (d1, d2)):
        worst = max(float((a[k].float() - b[k].float()).abs().max()) for k in a)
        assert worst <= 2 * LR_D, worst


def test_dropout_step_is_seeded(case):
    """deterministic=False: dropout everywhere, the text pass through the
    fused attention's plain path with its Philox mask. The same generator
    seed repeats the step exactly; another seed gives other losses."""
    _, cfg, batch, pg, pd = case

    def run(seed):
        G, D = _port_models(cfg, pg, pd)
        state = GANTrainState.create(G, D, build_optimizer(G, reg_interval=4),
                                     build_optimizer(D, reg_interval=16))
        step = make_train_step(batch_size=B, z_dim=4, max_elements=N, deterministic=False)
        stats = step(state, _torch(batch), torch.Generator().manual_seed(seed))
        return {k: float(v) for k, v in stats.items()}

    a, b, c = run(0), run(0), run(1)
    assert all(np.isfinite(v) for v in a.values())
    assert a == b
    assert a["Loss/G/loss_Ggen_text_rec"] != c["Loss/G/loss_Ggen_text_rec"]
    assert a["Loss/D/loss_Dreal"] != c["Loss/D/loss_Dreal"]


def test_port_config_reads_the_jax_config():
    jcfg, cfg = tiny_configs(reconst_decoder_layers=1, uncond_encoder_layers=1)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    for which in ("encoder_bert_config", "decoder_bert_config"):
        port, ref = getattr(cfg, which)(), getattr(jcfg, which)()
        for f in dataclasses.fields(port):
            if f.name != "flash_attention":
                assert getattr(port, f.name) == getattr(ref, f.name), (which, f.name)
