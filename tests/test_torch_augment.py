"""ADA augmentation: the port's ``training/augment.py`` vs the JAX package's.

The port draws on the host and applies on the device; JAX draws inside
``augment_pipe``. ``_jax_draws`` replays JAX's draws (its key splits, in
``augment_pipe``'s order, with its two quirks: the saturation gate reads
``keys[14]``, and the noise group draws its gate and its noise image from
the same key) into the port's parameter dict, so ``apply_augment`` and
``augment_pipe`` can be held against each other on the same draws.
Bars: the filter bank 1e-7 (the same float64 construction); the
resample 1e-6 on the same sampling grid and the filter 1e-5 (fp32 sums in
another order); the whole pipe at p = 1, on N(0, 1) images and JAX's
grid, 1e-5 of max |out| for CONDITIONAL_SAFE and 2e-5 for the full pipe,
whose seven composed 3x3 matrices differ from JAX's by a few ulps (another
summation order), which moves each tap by ~1e-5 px.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from layoutdetr_tpu.training import augment as jaug
from layoutdetr_tpu_torch.training import augment as aug

from test_torch_common import assert_max_abs
from test_torch_common import one_torch_thread  # noqa: F401 (module-scoped autouse fixture)

B, S = 4, 32


def _images(seed=0, b=B, s=S):
    return np.random.default_rng(seed).normal(size=(b, s, s, 3)).astype(np.float32)


def _jax_draws(rng, b, p, cfg, shape):
    """JAX's draws of ``augment_pipe(images, p, rng, cfg)`` as the port's
    parameter dict, and its noise image."""
    keys = jax.random.split(rng, 17)
    p32 = jnp.float32(p)

    def fires(key, strength, shape=(b,)):
        return np.asarray(jax.random.uniform(key, shape) < p32 * strength)

    def arr(x):
        return torch.from_numpy(np.array(x))

    out = {}
    if cfg.xflip > 0:
        out["xflip"] = arr(fires(keys[0], cfg.xflip))
    if cfg.rotate90 > 0:
        out["rotate90_k"] = arr(jax.random.randint(keys[1], (b,), 0, 4)).long()
        out["rotate90"] = arr(fires(keys[2], cfg.rotate90))
    if cfg.xint > 0:
        out["xint_t"] = arr(jax.random.uniform(keys[3], (b, 2), minval=-cfg.xint_max,
                                               maxval=cfg.xint_max))
        out["xint"] = arr(fires(keys[4], cfg.xint))
    if cfg.scale > 0:
        out["scale_n"] = arr(jax.random.normal(keys[5], (b,)))
        out["scale"] = arr(fires(keys[6], cfg.scale))
    if cfg.rotate > 0:
        out["rotate_u"] = arr(jax.random.uniform(keys[7], (b,), minval=-jnp.pi, maxval=jnp.pi))
        out["rotate"] = arr(fires(keys[8], cfg.rotate))
    if cfg.aniso > 0:
        out["aniso_n"] = arr(jax.random.normal(keys[9], (b,)))
        out["aniso"] = arr(fires(keys[10], cfg.aniso))
    if cfg.xfrac > 0:
        out["xfrac_n"] = arr(jax.random.normal(keys[11], (b, 2)))
        out["xfrac"] = arr(fires(keys[12], cfg.xfrac))
    kc = jax.random.split(keys[13], 8)
    out["brightness_n"] = arr(jax.random.normal(kc[0], (b,)))
    out["brightness"] = arr(fires(kc[1], cfg.brightness))
    out["contrast_n"] = arr(jax.random.normal(kc[2], (b,)))
    out["contrast"] = arr(fires(kc[3], cfg.contrast))
    out["lumaflip"] = arr(fires(kc[4], cfg.lumaflip))
    out["hue_u"] = arr(jax.random.uniform(kc[5], (b,), minval=-jnp.pi, maxval=jnp.pi))
    out["hue"] = arr(fires(kc[6], cfg.hue))
    out["saturation_n"] = arr(jax.random.normal(kc[7], (b,)))
    out["saturation"] = arr(fires(keys[14], cfg.saturation))  # JAX's gate key
    kf = jax.random.split(keys[16], 2 * 4 + 2)
    out["imgfilter_n"] = torch.stack([arr(jax.random.normal(kf[2 * i], (b,))) for i in range(4)], 1)
    out["imgfilter"] = torch.stack(
        [arr(fires(kf[2 * i + 1], cfg.imgfilter * s)) for i, s in enumerate(cfg.imgfilter_bands)], 1)
    kn = jax.random.split(keys[15], 4)
    out["noise_n"] = arr(jax.random.normal(kn[0], (b,)))
    out["noise"] = arr(fires(kn[1], cfg.noise))
    noise = arr(jax.random.normal(kn[1], shape))  # the gate's key again
    out["cutout_c"] = arr(jax.random.uniform(kn[2], (b, 2)))
    out["cutout"] = arr(fires(kn[3], cfg.cutout))
    out["noise_seed"] = 0
    return out, noise


def test_filter_bank_matches_jax():
    assert aug._FBANK.dtype == np.float32 and aug._FBANK.shape == jaug._FBANK.shape
    np.testing.assert_allclose(aug._FBANK, jaug._FBANK, rtol=0, atol=1e-7)


def test_bilinear_sample_matches_jax_out_of_range_included():
    img = _images(1, b=2, s=8)
    rng = np.random.default_rng(2)
    gx = rng.uniform(-2.5, 9.5, size=(2, 8, 8)).astype(np.float32)  # taps off every edge
    gy = rng.uniform(-2.5, 9.5, size=(2, 8, 8)).astype(np.float32)
    gx[0, 0, :3] = [-1.0, 7.0, 7.5]  # whole-pixel and half-outside taps
    want = jax.vmap(jaug.bilinear_sample)(img, gx, gy)
    got = aug.bilinear_sample(*(torch.from_numpy(a) for a in (img, gx, gy)))
    assert_max_abs(got, np.asarray(want), 1e-6, "bilinear_sample")
    assert float(got[0, 0, 0].abs().max()) < float(np.abs(img).max())  # a partly outside tap fades


def _jax_grid(h, w):
    ys, xs = jnp.meshgrid(jnp.linspace(-1, 1, h), jnp.linspace(-1, 1, w), indexing="ij")
    return torch.from_numpy(np.array(jnp.stack([xs, ys, jnp.ones_like(xs)], -1)))


def test_ndc_grid_is_jax_grid_to_an_ulp():
    for n in (32, 256):
        want = _jax_grid(n, n)
        assert_max_abs(aug._ndc_grid(n, n, "cpu"), want.numpy(), 2 * 2.0 ** -23, f"grid {n}")


@pytest.mark.parametrize("which", ["rotate_scale", "translate_out"])
def test_apply_affine_matches_jax(which, monkeypatch):
    """On JAX's grid, 1e-6. On the port's own grid, whose linspace lies an
    ulp from jnp.linspace's, 5e-5: an ulp of the grid moves a tap by up to
    ~4e-6 px, and N(0, 1) images jump by up to ~6 between pixels."""
    img = _images(3)
    th = np.linspace(-2.0, 2.0, B).astype(np.float32)
    if which == "rotate_scale":
        mats = np.stack([np.array([[1.3 * np.cos(t), -np.sin(t), 0.1],
                                   [np.sin(t), 0.8 * np.cos(t), -0.2], [0, 0, 1]]) for t in th])
    else:  # most taps outside the image
        mats = np.stack([np.array([[1, 0, 0.9 + t], [0, 1, -1.1], [0, 0, 1]]) for t in th])
    mats = mats.astype(np.float32)
    want = np.asarray(jaug._apply_affine(img, mats))
    assert (want == 0).mean() > 0.1  # taps out of range
    own = aug._apply_affine(torch.from_numpy(img), torch.from_numpy(mats))
    assert_max_abs(own, want, 5e-5, f"{which}, the port's grid")
    monkeypatch.setattr(aug, "_ndc_grid", lambda h, w, device: _jax_grid(h, w))
    got = aug._apply_affine(torch.from_numpy(img), torch.from_numpy(mats))
    assert_max_abs(got, want, 1e-6, f"{which}, JAX's grid")


def test_apply_imgfilter_matches_jax():
    img = _images(4)
    hz = np.random.default_rng(5).normal(size=(B, aug._FBANK.shape[1])).astype(np.float32) * 0.3
    want = jaug._apply_imgfilter(img, hz)
    got = aug._apply_imgfilter(torch.from_numpy(img), torch.from_numpy(hz))
    assert_max_abs(got, np.asarray(want), 1e-5, "imgfilter")


_JAX_PIPE = jax.jit(jaug.augment_pipe, static_argnums=(3,))


@pytest.mark.parametrize("cfg_name", ["full", "conditional_safe"])
def test_apply_augment_matches_jax_at_p1(cfg_name, monkeypatch):
    monkeypatch.setattr(aug, "_ndc_grid", lambda h, w, device: _jax_grid(h, w))
    rel = 2e-5 if cfg_name == "full" else 1e-5
    jcfg = jaug.AugmentConfig() if cfg_name == "full" else jaug.CONDITIONAL_SAFE
    cfg = aug.AugmentConfig(**dataclasses.asdict(jcfg))
    assert cfg == (aug.AugmentConfig() if cfg_name == "full" else aug.CONDITIONAL_SAFE)
    img = _images(6)
    for seed in (0, 1):
        rng = jax.random.PRNGKey(seed)
        want = np.asarray(_JAX_PIPE(img, 1.0, rng, jcfg))
        params, noise = _jax_draws(rng, B, 1.0, jcfg, img.shape)
        got = aug.apply_augment(torch.from_numpy(img), params, cfg, noise=noise)
        assert_max_abs(got, want, rel * max(1.0, float(np.abs(want).max())),
                       f"{cfg_name} seed {seed}")
        assert float(np.abs(want - img).max()) > 0.1  # the pipe did change the images


@pytest.mark.parametrize("cfg_name", ["full", "conditional_safe"])
def test_p0_returns_the_input(cfg_name):
    cfg = aug.AugmentConfig() if cfg_name == "full" else aug.CONDITIONAL_SAFE
    jcfg = jaug.AugmentConfig() if cfg_name == "full" else jaug.CONDITIONAL_SAFE
    img = _images(7)
    want = np.asarray(_JAX_PIPE(img, 0.0, jax.random.PRNGKey(3), jcfg))
    assert_max_abs(want, img, 1e-6, "JAX at p=0")
    params = aug.draw_augment_params(B, 0.0, torch.Generator().manual_seed(3), cfg)
    got = aug.apply_augment(torch.from_numpy(img), params, cfg)
    assert_max_abs(got, img, 1e-6, "port at p=0")


def test_port_draws_fire_at_p_times_strength():
    """Over 4096 samples each gate fires at p x strength within 3 sigma."""
    n, p = 4096, 0.3
    cfg = dataclasses.replace(aug.AugmentConfig(), contrast=0.5, imgfilter_bands=(1.0, 0.5, 1.0, 0.25))
    params = aug.draw_augment_params(n, p, torch.Generator().manual_seed(0), cfg)
    gates = [k for k, v in params.items() if isinstance(v, torch.Tensor) and v.dtype == torch.bool]
    assert len(gates) == 15
    for name in gates:
        g = params[name].float()
        if name == "imgfilter":
            strengths = torch.tensor(cfg.imgfilter_bands) * cfg.imgfilter
            rates, want = g.mean(0), p * strengths
        else:
            rates, want = g.mean()[None], torch.tensor([p * getattr(cfg, name)])
        sigma = torch.sqrt(want * (1 - want) / n)
        assert ((rates - want).abs() <= 3 * sigma).all(), (name, rates, want)
    assert params["rotate90_k"].unique().tolist() == [0, 1, 2, 3]
    for name in ("rotate_u", "hue_u"):
        assert params[name].abs().max() <= math.pi
    assert params["xint_t"].abs().max() <= cfg.xint_max


def test_affine_skip_is_decided_on_the_host_and_exact():
    """No geometric gate fires: the images pass unchanged (no resample);
    one sample's xflip fires: the batch is resampled (as in JAX), that
    sample mirrored and the others through the identity."""
    img = torch.from_numpy(_images(8))
    cfg = dataclasses.replace(aug.CONDITIONAL_SAFE, xflip=1.0, brightness=0, contrast=0, lumaflip=0,
                              hue=0, saturation=0, imgfilter=0, noise=0, cutout=0)
    params = aug.draw_augment_params(B, 0.0, torch.Generator().manual_seed(0), cfg)
    assert torch.equal(aug.apply_augment(img, params, cfg), img)
    params["xflip"][1] = True
    out = aug.apply_augment(img, params, cfg)
    assert_max_abs(out[[0, 2, 3]], img[[0, 2, 3]].numpy(), 5e-5, "identity")  # grid ulps, as above
    assert_max_abs(out[1], img[1].flip(1).numpy(), 5e-5, "xflip")


def test_ada_controller_matches_jax():
    ours = aug.AdaController(target=0.6, kimg=0.5)
    ref = jaug.AdaController(target=0.6, kimg=0.5)
    signs = np.random.default_rng(0).uniform(-1, 1, size=60)
    got = [ours.update(i, 16, s) for i, s in enumerate(signs)]
    want = [ref.update(i, 16, s) for i, s in enumerate(signs)]
    assert got == want and max(got) > 0
    assert ours.updates == 15
