"""Port resampling ops and D's StyleGAN2 background decoder vs the JAX
package's.

``upfirdn2d`` and ``conv2d_resample`` take NCHW / OIHW in the port and
NHWC / HWIO in JAX; the cases are tests/test_ops.py:56-84's, negative
pads included. ``Decoder`` (every bias_act through the port's Function,
its plain version on the CPU) is compared in its output and its
gradients with respect to every parameter and to z. fp32, 1e-5 max-abs
for the ops; the Decoder 1e-5 relative to max |image| (images reach ~10)
and grads 1e-5 of each leaf's max |g|."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from layoutdetr_tpu.ops import conv2d_resample as jax_conv2d_resample
from layoutdetr_tpu.ops import setup_filter as jax_setup_filter
from layoutdetr_tpu.ops import upfirdn2d as jax_upfirdn2d
from layoutdetr_tpu.models.stylegan2 import Decoder as JaxDecoder
from layoutdetr_tpu_torch.models.stylegan2 import Decoder
from layoutdetr_tpu_torch.ops.conv2d_resample import conv2d_resample
from layoutdetr_tpu_torch.ops.upfirdn2d import setup_filter, upfirdn2d, upsample2d
from layoutdetr_tpu_torch.utils.convert import JaxParams, _decoder_resolutions

from test_torch_common import assert_max_abs, load_port, random_params
from test_torch_common import one_torch_thread  # noqa: F401 (module-scoped autouse fixture)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def test_setup_filter_matches_jax():
    for f, kw in (([1, 3, 3, 1], {}), ([1, 3, 3, 1] * 2, dict(separable=True)),
                  ([1, 2, 1], dict(flip_filter=True, gain=2))):
        np.testing.assert_array_equal(setup_filter(f, **kw), jax_setup_filter(f, **kw))


@pytest.mark.parametrize(
    "up,down,padding,sep",
    [
        (1, 1, 0, False),
        (2, 1, [2, 1, 2, 1], False),
        (1, 2, [1, 1, 1, 1], False),
        (2, 2, 2, False),
        (2, 1, [2, 1, 2, 1], True),
        (1, 2, [1, 2, 1, 2], True),
        (1, 1, [-1, 1, 2, -1], False),  # negative padding = crop
        (2, 1, [-1, 2, 1, -2], False),
    ],
)
def test_upfirdn2d_matches_jax(up, down, padding, sep):
    x = np.random.default_rng(2).normal(size=(2, 8, 8, 3)).astype(np.float32)
    f = setup_filter([1, 3, 3, 1] * 2, separable=True) if sep else setup_filter([1, 3, 3, 1])
    want = np.asarray(jax_upfirdn2d(jnp.asarray(x), f, up=up, down=down, padding=padding, gain=1.5))
    got = _nhwc(upfirdn2d(_nchw(x), f, up=up, down=down, padding=padding, gain=1.5))
    assert got.shape == want.shape
    assert_max_abs(got, want, 1e-5, f"upfirdn2d up={up} down={down} pad={padding}")


@pytest.mark.parametrize("up,down,kernel", [(1, 1, 3), (2, 1, 3), (1, 2, 3), (1, 1, 1), (2, 1, 1),
                                            (1, 2, 1)])
def test_conv2d_resample_matches_jax(up, down, kernel):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    w = (rng.normal(size=(5, 4, kernel, kernel)) * 0.3).astype(np.float32)  # OIHW
    f = setup_filter([1, 3, 3, 1])
    kw = dict(f=f, up=up, down=down, padding=kernel // 2, flip_weight=(up == 1))
    want = np.asarray(jax_conv2d_resample(jnp.asarray(x), jnp.asarray(w.transpose(2, 3, 1, 0)), **kw))
    got = _nhwc(conv2d_resample(_nchw(x), torch.from_numpy(w), **kw))
    assert got.shape == want.shape
    assert_max_abs(got, want, 1e-5, f"conv2d_resample up={up} down={down} k={kernel}")


def test_upsample2d_keeps_the_image_mean():
    x = torch.ones(1, 3, 4, 4)
    y = upsample2d(x, setup_filter([1, 3, 3, 1]))
    assert y.shape == (1, 3, 8, 8)
    assert torch.allclose(y[..., 2:-2, 2:-2], torch.ones(1, 3, 4, 4))


def test_decoder_and_grads_match_jax():
    """D's bg_decoder at small size (z 8, w 16, 32x32, channel_base 256,
    channel_max 16): 8 mapping FCs, blocks b4 ... b32."""
    z = np.random.default_rng(0).normal(size=(2, 8)).astype(np.float32)
    cot = np.random.default_rng(1).normal(size=(2, 32, 32, 3)).astype(np.float32)
    jm = JaxDecoder(z_dim=8, w_dim=16, img_resolution=32, img_channels=3, use_noise=False,
                    channel_base=256, channel_max=16, conv_clamp=None)
    params = random_params(jm, z)
    img, vjp = jax.vjp(lambda p, zz: jm.apply({"params": p}, zz), params, jnp.asarray(z))
    grads, gz = vjp(jnp.asarray(cot))

    c = JaxParams({"d": params})
    c.stylegan2_decoder("d", "", _decoder_resolutions(32))
    port = load_port(Decoder(8, 16, 32, 3, channel_base=256, channel_max=16), c.finish())
    tz = torch.from_numpy(z).requires_grad_(True)
    got = port(tz)
    assert got.shape == (2, 32, 32, 3)
    scale = float(np.abs(np.asarray(img)).max())
    assert_max_abs(got, np.asarray(img), 1e-5 * scale, "Decoder image")

    names = [n for n, _ in port.named_parameters()]
    got_g = torch.autograd.grad(got, [dict(port.named_parameters())[n] for n in names] + [tz],
                                torch.from_numpy(cot))
    g = JaxParams({"d": jax.tree.map(np.asarray, grads)})
    g.stylegan2_decoder("d", "", _decoder_resolutions(32))
    want_g = dict(g.finish(), z=torch.from_numpy(np.array(gz)))
    for name, gg in zip(names + ["z"], got_g):
        leaf = max(float(want_g[name].abs().max()), 1e-30)
        assert float((gg - want_g[name]).abs().max()) <= 1e-5 * leaf, name
