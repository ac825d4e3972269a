"""Port resampling ops, D's StyleGAN2 background decoder and the StyleGAN2
encoder stack (``Conv2dLayer``, ``MappingNetwork``, ``DiscriminatorBlock``,
``MinibatchStdLayer``, ``EncoderEpilogue``, ``Encoder``) vs the JAX
package's.

``upfirdn2d`` and ``conv2d_resample`` take NCHW / OIHW in the port and
NHWC / HWIO in JAX; the cases are tests/test_ops.py:56-84's, negative
pads included. ``Decoder`` (every bias_act through the port's Function,
its plain version on the CPU) is compared in its output and its
gradients with respect to every parameter and to z. fp32, 1e-5 max-abs
for the ops; the Decoder 1e-5 relative to max |image| (images reach ~10)
and grads 1e-5 of each leaf's max |g|. The encoder modules: outputs and
the gradients of every parameter and input, 1e-5 of max(1, max |y|) and
of each leaf's max |g|."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from layoutdetr_tpu.ops import conv2d_resample as jax_conv2d_resample
from layoutdetr_tpu.ops import setup_filter as jax_setup_filter
from layoutdetr_tpu.ops import upfirdn2d as jax_upfirdn2d
from layoutdetr_tpu.models import stylegan2 as jsg
from layoutdetr_tpu.models.stylegan2 import Decoder as JaxDecoder
from layoutdetr_tpu_torch.models import stylegan2 as sg
from layoutdetr_tpu_torch.models.stylegan2 import Decoder
from layoutdetr_tpu_torch.ops.conv2d_resample import conv2d_resample
from layoutdetr_tpu_torch.ops.upfirdn2d import setup_filter, upfirdn2d, upsample2d
from layoutdetr_tpu_torch.utils.convert import JaxParams, _decoder_resolutions

from test_torch_common import assert_max_abs, load_port, max_abs, random_params
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


# ---------------------------------------------------------------------------
# the encoder stack
# ---------------------------------------------------------------------------

def _port_in(x):
    if x is None:
        return None
    t = _nchw(x) if x.ndim == 4 else torch.from_numpy(x)
    return t.requires_grad_(True)


def _port_out(t):
    return t.detach().numpy().transpose(0, 2, 3, 1) if t.dim() == 4 else t.detach().numpy()


def _converted(fill, tree):
    c = JaxParams({"m": tree})
    fill(c)
    return c.finish()


def _check_against_jax(jm, port, fill, inputs, seed=0, **kw):
    """Outputs of ``jm`` and ``port`` on the same inputs (NHWC for JAX, NCHW
    for the port; None stays None), then the gradients of a fixed random
    scalar of the outputs with respect to every parameter and input."""
    params = random_params(jm, *inputs, **kw)
    idx = [i for i, x in enumerate(inputs) if x is not None]

    def outputs(p, *xs):
        full = list(inputs)
        for i, x in zip(idx, xs):
            full[i] = x
        out = jm.apply({"params": p}, *full, **kw)
        return [o for o in (out if isinstance(out, tuple) else (out,)) if o is not None]

    want, vjp = jax.vjp(outputs, params, *[jnp.asarray(inputs[i]) for i in idx])
    rng = np.random.default_rng(seed + 1)
    cots = [rng.normal(size=w.shape).astype(np.float32) for w in want]
    grads = vjp([jnp.asarray(c) for c in cots])

    port = load_port(port, _converted(fill, params))
    tin = [_port_in(x) for x in inputs]
    got = port(*tin, **kw)
    got = [o for o in (got if isinstance(got, tuple) else (got,)) if o is not None]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert _port_out(g).shape == w.shape, i
        assert_max_abs(_port_out(g), w, 1e-5 * max(1.0, float(np.abs(w).max())), f"output {i}")
    names = [n for n, _ in port.named_parameters()]
    wrt = [dict(port.named_parameters())[n] for n in names] + [tin[i] for i in idx]
    got_g = torch.autograd.grad(got, wrt, [_port_in(c).detach() for c in cots], allow_unused=True)
    want_g = _converted(fill, jax.tree.map(np.asarray, grads[0]))
    want_g = [want_g[n].numpy() for n in names] + [np.asarray(g) for g in grads[1:]]
    for k, (name, g, w) in enumerate(zip(names + [f"input {i}" for i in idx], got_g, want_g)):
        if g is None:
            g = np.zeros(w.shape, np.float32)
        else:  # inputs' gradients NCHW -> NHWC; parameters' are in the port's layout
            g = _port_out(g) if k >= len(names) else g.detach().numpy()
        assert max_abs(g, w) <= 1e-5 * max(float(np.abs(w).max()), 1e-30), name
    return params


def _conv_fill(bias=True, name=""):
    return lambda c: c.conv2d_layer(f"m/{name}".rstrip("/"), name, bias=bias)


@pytest.mark.parametrize("kernel,up,down,bias,act,clamp,gain", [
    (3, 1, 1, True, "lrelu", 0.5, 1.0),  # the clamp at 0.5 * gain
    (3, 2, 1, True, "lrelu", None, 1.0),
    (3, 1, 2, True, "lrelu", None, 0.5 ** 0.5),  # conv1 of a resnet block
    (1, 1, 2, False, "linear", None, 0.5 ** 0.5),  # its bias-less skip
    (1, 2, 1, False, "linear", None, 1.0),
    (1, 1, 1, True, "relu", None, 2.0),
])
def test_conv2d_layer_matches_jax(kernel, up, down, bias, act, clamp, gain):
    x = np.random.default_rng(4).normal(size=(2, 8, 8, 4)).astype(np.float32)
    jm = jsg.Conv2dLayer(5, kernel, use_bias=bias, activation=act, up=up, down=down,
                         conv_clamp=clamp)
    port = sg.Conv2dLayer(4, 5, kernel, bias=bias, activation=act, up=up, down=down,
                          conv_clamp=clamp)
    assert (port.bias is None) == (not bias)
    _check_against_jax(jm, port, _conv_fill(bias), [x], gain=gain)


@pytest.mark.parametrize("c_dim,num_ws", [(3, 3), (0, None)])
def test_mapping_network_matches_jax(c_dim, num_ws):
    rng = np.random.default_rng(5)
    z = rng.normal(size=(2, 6)).astype(np.float32)
    c = rng.normal(size=(2, c_dim)).astype(np.float32) if c_dim else None

    def fill(cv):
        if c_dim:
            cv.fully_connected("m/embed", "embed")
        for i in range(2):
            cv.fully_connected(f"m/fc{i}", f"fc{i}")

    _check_against_jax(jsg.MappingNetwork(6, c_dim, 8, num_ws, num_layers=2),
                       sg.MappingNetwork(6, c_dim, 8, num_ws, num_layers=2), fill, [z, c])


@pytest.mark.parametrize("architecture", ["resnet", "skip"])
@pytest.mark.parametrize("first", [True, False])
def test_discriminator_block_matches_jax(architecture, first):
    rng = np.random.default_rng(6)
    in_ch = 0 if first else 4
    x = None if first else rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    img = rng.normal(size=(2, 8, 8, 3)).astype(np.float32) if first or architecture == "skip" \
        else None

    def fill(c):
        if first or architecture == "skip":
            c.conv2d_layer("m/fromrgb", "fromrgb")
        if architecture == "resnet":
            c.conv2d_layer("m/skip", "skip", bias=False)
        for name in ("conv0", "conv1"):
            c.conv2d_layer(f"m/{name}", name)

    _check_against_jax(jsg.DiscriminatorBlock(in_ch, 4, 6, architecture=architecture,
                                              conv_clamp=256.0),
                       sg.DiscriminatorBlock(in_ch, 4, 6, architecture=architecture,
                                             conv_clamp=256.0), fill, [x, img])


@pytest.mark.parametrize("n", [4, 8])
def test_minibatch_std_layer_matches_jax(n):
    """n = 8 over groups of 4: sample i takes subgroup i // 4's statistic,
    as JAX's ``jnp.repeat`` gives it."""
    x = np.random.default_rng(7).normal(size=(n, 3, 3, 4)).astype(np.float32)
    want = np.asarray(jsg.MinibatchStdLayer(group_size=4, num_channels=2).apply({}, jnp.asarray(x)))
    got = _port_out(sg.MinibatchStdLayer(group_size=4, num_channels=2)(_nchw(x)))
    assert got.shape == want.shape == (n, 3, 3, 6)
    assert_max_abs(got, want, 1e-5, "MinibatchStdLayer")


@pytest.mark.parametrize("architecture", ["resnet", "skip"])
def test_encoder_epilogue_matches_jax(architecture):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 4, 4, 8)).astype(np.float32)
    img = rng.normal(size=(2, 4, 4, 3)).astype(np.float32) if architecture == "skip" else None

    def fill(c):
        if architecture == "skip":
            c.conv2d_layer("m/fromrgb", "fromrgb")
        c.conv2d_layer("m/conv", "conv")
        for name in ("fc", "out"):
            c.fully_connected(f"m/{name}", name)

    _check_against_jax(jsg.EncoderEpilogue(5, architecture=architecture, conv_clamp=256.0),
                       sg.EncoderEpilogue(8, 5, architecture=architecture, conv_clamp=256.0),
                       fill, [x, img])


@pytest.mark.parametrize("architecture,clamp", [("resnet", 256.0), ("resnet", None),
                                                ("skip", 256.0)])
def test_encoder_matches_jax(architecture, clamp):
    """32x32 -> 8, channel_base 256, channel_max 16: blocks b32, b16, b8 and
    the epilogue b4, under StyleGAN2's names."""
    img = np.random.default_rng(9).normal(size=(2, 32, 32, 3)).astype(np.float32)
    kw = dict(architecture=architecture, channel_base=256, channel_max=16, conv_clamp=clamp)
    port = sg.Encoder(32, 8, **kw)
    names = {n for n, _ in port.named_parameters()}
    assert {"b32.fromrgb.weight", "b4.conv.weight", "b4.fc.weight", "b4.out.bias"} <= names
    assert ("b32.skip.weight" in names) == (architecture == "resnet")
    assert "b32.skip.bias" not in names
    _check_against_jax(jsg.Encoder(32, 8, **kw), port,
                       lambda c: c.stylegan2_encoder("m", "", 32, architecture), [img])
