"""ADA augmentation of the critic's background input, and its controller.

Counterpart of ``layoutdetr_tpu/training/augment.py`` (reference
training/augment.py:120-434 and the controller of training_loop.py:165-171,
334-338), split in two:

- ``draw_augment_params(b, p, generator, cfg)`` makes every per-sample
  draw on the host, from a CPU ``torch.Generator``: each group's gate
  (fires with probability ``p * strength``) and its random values, as
  [B] / [B, k] CPU tensors, plus the seed of the per-pixel noise image;
- ``apply_augment(images, params, cfg)`` applies them to channels-last
  [B, S, S, 3] images on the images' device: the geometric group
  (xflip, 90-degree rotations, integer and fractional translation,
  isotropic and anisotropic scale, rotation) composed into one 3x3 matrix
  a sample and applied by one bilinear resample; the color group
  (brightness, contrast, luma flip, hue, saturation) composed into one
  4x4 matrix a sample; the wavelet-band image filter (a per-sample
  separable FIR, as a grouped convolution after reflect padding);
  additive RGB noise; cutout.

The small matrices are composed on the host from the drawn values, and a
group that changes no sample is skipped there too, so no step waits on
the card for that decision (JAX decides the affine skip on the device
with ``lax.cond`` when every matrix is the identity).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    # Group strengths; 1 = enabled at probability p (augment.py:120-158 defaults).
    xflip: float = 1.0
    rotate90: float = 1.0
    xint: float = 1.0
    xint_max: float = 0.125
    scale: float = 1.0
    rotate: float = 1.0
    aniso: float = 1.0
    xfrac: float = 1.0
    scale_std: float = 0.2
    rotate_max: float = 1.0
    aniso_std: float = 0.2
    xfrac_std: float = 0.125
    brightness: float = 1.0
    contrast: float = 1.0
    lumaflip: float = 1.0
    hue: float = 1.0
    saturation: float = 1.0
    brightness_std: float = 0.2
    contrast_std: float = 0.5
    hue_max: float = 1.0
    saturation_std: float = 1.0
    imgfilter: float = 1.0
    imgfilter_bands: tuple = (1.0, 1.0, 1.0, 1.0)
    imgfilter_std: float = 1.0
    noise: float = 1.0
    cutout: float = 1.0
    noise_std: float = 0.1
    cutout_size: float = 0.5


# The groups that leave content in place (color, band filter, noise,
# cutout): geometric warps would move the background under the fixed bbox
# inputs of the same conditional critic. The training default; the full
# pipe is behind --aug-geom.
CONDITIONAL_SAFE = AugmentConfig(xflip=0.0, rotate90=0.0, xint=0.0, scale=0.0, rotate=0.0,
                                 aniso=0.0, xfrac=0.0)


def _build_fbank(num_bands: int = 4) -> np.ndarray:
    """The 4-band wavelet filter bank (augment.py:172-182): sym2 low/high
    autocorrelations cascaded with zero-upsampling; the bands sum to an
    allpass."""
    import scipy.signal

    sym2 = np.asarray([-0.12940952255092145, 0.22414386804185735,
                       0.836516303737469, 0.48296291314469025])
    hz_lo = sym2
    hz_hi = hz_lo * ((-1) ** np.arange(hz_lo.size))
    hz_lo2 = np.convolve(hz_lo, hz_lo[::-1]) / 2
    hz_hi2 = np.convolve(hz_hi, hz_hi[::-1]) / 2
    fbank = np.eye(num_bands, 1)
    for i in range(1, num_bands):
        fbank = np.dstack([fbank, np.zeros_like(fbank)]).reshape(num_bands, -1)[:, :-1]
        fbank = scipy.signal.convolve(fbank, [hz_lo2])
        lo = (fbank.shape[1] - hz_hi2.size) // 2
        fbank[i, lo:lo + hz_hi2.size] += hz_hi2
    return fbank.astype(np.float32)


_FBANK = _build_fbank()
_EXPECTED_POWER = (10.0, 1.0, 1.0, 1.0)  # per band, over 13


# ---------------------------------------------------------------------------
# the draws (host)
# ---------------------------------------------------------------------------

def draw_augment_params(b: int, p: float, generator: torch.Generator,
                        cfg: AugmentConfig = AugmentConfig()) -> dict:
    """Every per-sample draw of one augmentation of ``b`` images at
    probability ``p``, from the CPU generator ``generator``. Keys: a group
    name holds its gate ([B] bool, fires with probability p x strength),
    ``<group>_<v>`` its values; only enabled groups appear. ``noise_seed``
    seeds the per-pixel noise image on the device."""
    p = float(p)

    def fires(strength, *shape):
        return torch.rand(b, *shape, generator=generator) < p * strength

    def normal(*shape):
        return torch.randn(b, *shape, generator=generator)

    def uniform(lo, hi, *shape):
        return torch.rand(b, *shape, generator=generator) * (hi - lo) + lo

    out = {}
    if cfg.xflip > 0:
        out["xflip"] = fires(cfg.xflip)
    if cfg.rotate90 > 0:
        out["rotate90_k"] = torch.randint(0, 4, (b,), generator=generator)
        out["rotate90"] = fires(cfg.rotate90)
    if cfg.xint > 0:
        out["xint_t"] = uniform(-cfg.xint_max, cfg.xint_max, 2)
        out["xint"] = fires(cfg.xint)
    for name in ("scale", "aniso", "brightness", "contrast", "saturation", "noise"):
        if getattr(cfg, name) > 0:
            out[name + "_n"] = normal()
            out[name] = fires(getattr(cfg, name))
    for name in ("rotate", "hue"):
        if getattr(cfg, name) > 0:
            out[name + "_u"] = uniform(-math.pi, math.pi)
            out[name] = fires(getattr(cfg, name))
    if cfg.xfrac > 0:
        out["xfrac_n"] = normal(2)
        out["xfrac"] = fires(cfg.xfrac)
    if cfg.lumaflip > 0:
        out["lumaflip"] = fires(cfg.lumaflip)
    if cfg.imgfilter > 0:
        out["imgfilter_n"] = normal(len(cfg.imgfilter_bands))
        strengths = torch.tensor(cfg.imgfilter_bands) * cfg.imgfilter
        out["imgfilter"] = torch.rand(b, len(cfg.imgfilter_bands), generator=generator) < p * strengths
    if cfg.cutout > 0:
        out["cutout_c"] = torch.rand(b, 2, generator=generator)
        out["cutout"] = fires(cfg.cutout)
    out["noise_seed"] = int(torch.randint(0, 2 ** 62, (), generator=generator))
    return out


# ---------------------------------------------------------------------------
# composing the matrices (host)
# ---------------------------------------------------------------------------

def _mat(rows):
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _rot2d(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(theta), torch.ones_like(theta)
    return _mat([[c, -s, z], [s, c, z], [z, z, o]])


def _scale2d(sx, sy):
    z, o = torch.zeros_like(sx), torch.ones_like(sx)
    return _mat([[sx, z, z], [z, sy, z], [z, z, o]])


def _translate2d(tx, ty):
    z, o = torch.zeros_like(tx), torch.ones_like(tx)
    return _mat([[o, z, tx], [z, o, ty], [z, z, o]])


def _compose(m, gate, t):
    """Where ``gate``: t @ m, else m (one [B, k, k] stack)."""
    return torch.where(gate[:, None, None], t @ m, m)


def geometry_matrices(params: dict, cfg: AugmentConfig, b: int) -> torch.Tensor:
    """[B, 3, 3] maps from output to input NDC (augment.py:170-260)."""
    m = torch.eye(3).expand(b, 3, 3)
    one = torch.ones(b)
    if "xflip" in params:
        m = _compose(m, params["xflip"], _scale2d(-one, one))
    if "rotate90" in params:
        m = _compose(m, params["rotate90"], _rot2d(-math.pi / 2 * params["rotate90_k"].float()))
    if "xint" in params:
        t = params["xint_t"]
        m = _compose(m, params["xint"], _translate2d(2 * t[:, 0], 2 * t[:, 1]))
    if "scale" in params:
        s = torch.exp2(params["scale_n"] * cfg.scale_std)
        m = _compose(m, params["scale"], _scale2d(s, s))
    if "rotate" in params:
        m = _compose(m, params["rotate"], _rot2d(-params["rotate_u"] * cfg.rotate_max))
    if "aniso" in params:
        s = torch.exp2(params["aniso_n"] * cfg.aniso_std)
        m = _compose(m, params["aniso"], _scale2d(s, 1 / s))
    if "xfrac" in params:
        t = params["xfrac_n"] * cfg.xfrac_std
        m = _compose(m, params["xfrac"], _translate2d(2 * t[:, 0], 2 * t[:, 1]))
    return m


def color_matrices(params: dict, cfg: AugmentConfig, b: int) -> torch.Tensor:
    """[B, 4, 4] homogeneous RGB transforms (augment.py:263-330)."""
    eye = torch.eye(4).expand(b, 4, 4)
    c = eye
    v = torch.tensor([1.0, 1.0, 1.0, 0.0]) / math.sqrt(3.0)
    outer = torch.outer(v, v)
    if "brightness" in params:
        t = eye.clone()
        t[:, :3, 3] = (params["brightness_n"] * cfg.brightness_std)[:, None]
        c = _compose(c, params["brightness"], t)
    if "contrast" in params:
        t = eye * torch.exp2(params["contrast_n"] * cfg.contrast_std)[:, None, None]
        t[:, 3, 3] = 1.0
        c = _compose(c, params["contrast"], t)
    if "lumaflip" in params:
        c = _compose(c, params["lumaflip"], (torch.eye(4) - 2 * outer).expand(b, 4, 4))
    if "hue" in params:
        theta = params["hue_u"] * cfg.hue_max
        a = v[:3]
        k = torch.tensor([[0.0, -a[2], a[1]], [a[2], 0.0, -a[0]], [-a[1], a[0], 0.0]])
        rot3 = (torch.eye(3) + torch.sin(theta)[:, None, None] * k
                + (1 - torch.cos(theta))[:, None, None] * (k @ k))
        t = eye.clone()
        t[:, :3, :3] = rot3
        c = _compose(c, params["hue"], t)
    if "saturation" in params:
        s = torch.exp2(params["saturation_n"] * cfg.saturation_std)
        c = _compose(c, params["saturation"], outer + (torch.eye(4) - outer) * s[:, None, None])
    return c


def filter_taps(params: dict, cfg: AugmentConfig, b: int) -> torch.Tensor:
    """[B, taps] per-sample FIR of the band-gain draws (augment.py:374-404)."""
    n_bands = _FBANK.shape[0]
    power = torch.tensor(_EXPECTED_POWER) / 13.0
    gvec = torch.ones(b, n_bands)
    for i in range(len(cfg.imgfilter_bands)):
        t_i = torch.exp2(params["imgfilter_n"][:, i] * cfg.imgfilter_std)
        tvec = torch.ones(b, n_bands)
        tvec[:, i] = torch.where(params["imgfilter"][:, i], t_i, 1.0)
        gvec = gvec * tvec / torch.sqrt((power * tvec.square()).sum(-1, keepdim=True))
    return gvec @ torch.from_numpy(_FBANK)


# ---------------------------------------------------------------------------
# the transforms (device)
# ---------------------------------------------------------------------------

def bilinear_sample(img: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """img [B, H, W, C]; gx, gy [B, H', W'] in pixel coordinates ->
    [B, H', W', C]; taps outside the image read 0."""
    b, h, w, c = img.shape
    x0f, y0f = torch.floor(gx), torch.floor(gy)
    fx, fy = (gx - x0f)[..., None], (gy - y0f)[..., None]
    x0, y0 = x0f.long(), y0f.long()
    flat = img.reshape(b, h * w, c)

    def tap(yy, xx):
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
        v = flat.gather(1, idx.reshape(b, -1, 1).expand(-1, -1, c)).reshape(*gx.shape, c)
        return torch.where(inside[..., None], v, 0.0)

    v00, v01 = tap(y0, x0), tap(y0, x0 + 1)
    v10, v11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    return (v00 * (1 - fx) + v01 * fx) * (1 - fy) + (v10 * (1 - fx) + v11 * fx) * fy


def _ndc_grid(h: int, w: int, device) -> torch.Tensor:
    """[H, W, 3] homogeneous output coordinates (x, y, 1) in [-1, 1]."""
    ys, xs = torch.meshgrid(torch.linspace(-1, 1, h, device=device),
                            torch.linspace(-1, 1, w, device=device), indexing="ij")
    return torch.stack([xs, ys, torch.ones_like(xs)], -1)


def _apply_affine(images: torch.Tensor, mats: torch.Tensor) -> torch.Tensor:
    """images [B, H, W, C]; mats [B, 3, 3] mapping output NDC -> input NDC."""
    _, h, w, _ = images.shape
    src = torch.einsum("bij,hwj->bhwi", mats, _ndc_grid(h, w, images.device))
    return bilinear_sample(images, (src[..., 0] + 1) * 0.5 * (w - 1), (src[..., 1] + 1) * 0.5 * (h - 1))


def _apply_imgfilter(images: torch.Tensor, hz: torch.Tensor) -> torch.Tensor:
    """Per-sample separable FIR with reflect padding (augment.py:396-404):
    images [B, H, W, C], hz [B, T] -> [B, H, W, C]."""
    b, h, w, c = images.shape
    t = hz.shape[-1]
    p = t // 2
    x = images.permute(0, 3, 1, 2).reshape(1, b * c, h, w)
    x = F.pad(x, (p, p, p, p), mode="reflect")
    k = hz.repeat_interleave(c, 0)  # the filter of channel (i, ch) is hz[i]
    x = F.conv2d(x, k.view(b * c, 1, 1, t), groups=b * c)
    x = F.conv2d(x, k.view(b * c, 1, t, 1), groups=b * c)
    return x.reshape(b, c, h, w).permute(0, 2, 3, 1)


def apply_augment(images: torch.Tensor, params: dict, cfg: AugmentConfig = AugmentConfig(),
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Augment channels-last [B, H, W, C] ``images`` with the draws of
    ``draw_augment_params``. ``noise`` (standard normal, images' shape)
    replaces the noise image drawn on the device from ``noise_seed``."""
    b, h, w, _ = images.shape
    dev = images.device

    def put(t):
        return t.to(dev, non_blocking=True)

    m = geometry_matrices(params, cfg, b)
    if not torch.isclose(m, torch.eye(3).expand(b, 3, 3)).all():
        images = _apply_affine(images, put(m))

    c = color_matrices(params, cfg, b)
    if not torch.equal(c, torch.eye(4).expand(b, 4, 4)):
        c = put(c)
        images = torch.einsum("bij,bhwj->bhwi", c[:, :3, :3], images) + c[:, None, None, :3, 3]

    if "imgfilter" in params and params["imgfilter"].any():
        images = _apply_imgfilter(images, put(filter_taps(params, cfg, b)))

    if "noise" in params and params["noise"].any():
        sigma = params["noise_n"].abs() * cfg.noise_std * params["noise"].float()
        if noise is None:
            gen = torch.Generator(device=dev).manual_seed(params["noise_seed"])
            noise = torch.randn(images.shape, generator=gen, device=dev)
        images = images + noise * put(sigma)[:, None, None, None]

    if "cutout" in params and params["cutout"].any():
        center = put(params["cutout_c"])
        gate = put(params["cutout"])
        ys = torch.arange(h, device=dev) / h
        xs = torch.arange(w, device=dev) / w
        in_y = (ys[None, :] - center[:, 1:2]).abs() < cfg.cutout_size / 2
        in_x = (xs[None, :] - center[:, 0:1]).abs() < cfg.cutout_size / 2
        hole = in_y[:, :, None] & in_x[:, None, :] & gate[:, None, None]
        images = torch.where(hole[..., None], 0.0, images)
    return images


class AdaController:
    """The host's ADA probability controller (training_loop.py:334-338):
    every ``interval`` batches p moves by sign(E[sign(D_real)] - target)
    at speed batch * interval / (kimg * 1000), floored at 0."""

    def __init__(self, target: float = 0.6, interval: int = 4, kimg: float = 500.0,
                 initial_p: float = 0.0):
        self.target = target
        self.interval = interval
        self.kimg = kimg
        self.p = initial_p
        self.updates = 0

    def update(self, batch_idx: int, batch_size: int, signs_real_mean: float) -> float:
        if self.interval and batch_idx % self.interval == 0:
            adjust = np.sign(signs_real_mean - self.target) * (
                batch_size * self.interval) / (self.kimg * 1000)
            self.p = float(max(self.p + adjust, 0.0))
            self.updates += 1
        return self.p
