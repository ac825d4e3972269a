"""The port's ViT backbone (``models/vit.py``) and the LayoutDETR G and D
with ``backbone='vit'`` vs the JAX package's, on the same numpy inputs
with the JAX params carried across by ``utils/convert.py``, and the
frozen set under ``vit``.

``train --backbone vit`` is tested in test_torch_train_loop.py.

fp32: 1e-5 max-abs, relative above 1 for outputs and gradients that
exceed it (a gradient leaf against its own max |g|). bf16: 2e-2 of
max(1, max |y|), the bar of the port's bf16 attention tests (one bf16
rounding of outputs up to 4 is 1.6e-2); the two sides round the same
bf16 GEMMs, GELU and residual sums at different points.

The G and D tests and the frozen-set test patch the ViT to
width 16, depth 2, 2 heads on both sides (``monkeypatch``), to keep them
fast: JAX's ``_image_backbone`` imports ``VisionTransformer`` when it is
called, the port's ``image_backbone`` reads it from
``models/generator.py``. One test runs the full ViT-B (12 x 768, 12
heads) unpatched, at background 32 (4 tokens).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import layoutdetr_tpu.models.vit as jax_vit
from layoutdetr_tpu.models.discriminator import Discriminator as JaxDiscriminator
from layoutdetr_tpu.models.generator import Generator as JaxGenerator
from layoutdetr_tpu.training import optimizers as jax_opt
from layoutdetr_tpu_torch.models import generator as port_generator
from layoutdetr_tpu_torch.models import vit
from layoutdetr_tpu_torch.models.discriminator import Discriminator
from layoutdetr_tpu_torch.models.generator import Generator
from layoutdetr_tpu_torch.training.optimizers import freeze
from layoutdetr_tpu_torch.utils.convert import (
    JaxParams,
    discriminator_state_dict_from_jax,
    generator_state_dict_from_jax,
)

from test_torch_common import assert_max_abs, load_port, random_params, tiny_configs
from test_torch_common import one_torch_thread  # noqa: F401 (module-scoped autouse fixture)

TOL = 1e-5
BF16_TOL = 2e-2
NARROW = dict(embed_dim=16, depth=2, num_heads=2)


def _scaled(x):
    return max(1.0, float(np.abs(np.asarray(x, np.float32)).max()))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _converted(fill, src_tree):
    """Run ``fill(JaxParams)`` over ``src_tree`` and return the state dict."""
    c = JaxParams({"m": src_tree})
    fill(c)
    return c.finish()


def _check_grads(port_module, got_grads, jax_grads, convert, tol=TOL):
    """Every parameter's gradient against JAX's, carried across by the same
    converter; crossattention blocks (filled, JAX has none) are skipped."""
    want = convert(jax.tree.map(np.asarray, jax_grads))
    checked = 0
    for name, g in zip([n for n, _ in port_module.named_parameters()], got_grads):
        if ".crossattention." in name:
            continue
        w = want[name].numpy()
        assert_max_abs(torch.zeros(w.shape) if g is None else g, w, tol * _scaled(w), name)
        checked += 1
    assert checked > 10


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [32, 40])  # 40: the VALID conv drops the last 8 rows and columns
def test_patch_embed_matches_jax(size):
    x = np.random.default_rng(0).normal(size=(2, size, size, 3)).astype(np.float32)
    jm = jax_vit.PatchEmbed(16, 8)
    params = random_params(jm, x)
    want = np.asarray(jm.apply({"params": params}, x))
    sd = _converted(lambda c: (c.conv("m", "", leaf="kernel"), c.put("bias", c.take("m/bias"))),
                    params)
    port = load_port(vit.PatchEmbed(16, 3, 8), sd)
    got = port(_nchw(x))
    assert got.shape == want.shape == (2, 2, 2, 8)
    assert_max_abs(got, want, TOL, "PatchEmbed")


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_vit_block_matches_jax(dtype_name):
    """Output and gradients (every parameter, the input); in bf16 the
    output and the input's gradient, both in bf16 on both sides."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    cot = rng.normal(size=(2, 5, 16)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype_name), getattr(torch, dtype_name)
    jm = jax_vit.ViTBlock(16, 2, dtype=jdt)
    params = random_params(jm, x)
    y, vjp = jax.vjp(lambda p, xx: jm.apply({"params": p}, xx), params,
                     jnp.asarray(x).astype(jdt))
    grads, gx = vjp(jnp.asarray(cot).astype(y.dtype))
    sd = _converted(lambda c: c.vit_blocks("m", ""), {"blocks_0": params})
    port = load_port(vit.ViTBlock(16, 2, dtype=tdt), {k[len("blocks.0."):]: v for k, v in sd.items()})
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    got = port(tx)
    assert got.dtype == tdt and tuple(got.shape) == y.shape
    tol = TOL if dtype_name == "float32" else BF16_TOL
    assert_max_abs(got, np.asarray(y.astype(jnp.float32)), tol * _scaled(y.astype(jnp.float32)),
                   f"ViTBlock {dtype_name}")
    names = [n for n, _ in port.named_parameters()]
    got_g = torch.autograd.grad(got, [dict(port.named_parameters())[n] for n in names] + [tx],
                                torch.from_numpy(cot).to(tdt))
    gx32 = np.asarray(gx.astype(jnp.float32))
    assert_max_abs(got_g[-1], gx32, tol * _scaled(gx32), f"ViTBlock {dtype_name} dx")
    if dtype_name == "float32":
        _check_grads(port, got_g[:-1], {"blocks_0": grads},
                     lambda t: {k[len("blocks.0."):]: v for k, v in
                                _converted(lambda c: c.vit_blocks("m", ""), t).items()})


def _vit_params_case(jm, x):
    params = random_params(jm, x)
    return params, _converted(lambda c: c.vit("m", ""), params)


def test_vision_transformer_and_grads_match_jax():
    """Width 16, depth 2, 2 heads, background 64 (16 tokens); the NCHW map
    and every gradient."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    cot = rng.normal(size=(2, 4, 4, 16)).astype(np.float32)
    jm = jax_vit.VisionTransformer(**NARROW)
    params, sd = _vit_params_case(jm, x)
    y, vjp = jax.vjp(lambda p: jm.apply({"params": p}, x), params)
    (grads,) = vjp(jnp.asarray(cot))
    port = load_port(vit.VisionTransformer(64, **NARROW), sd)
    got = port(_nchw(x))
    assert got.shape == (2, 16, 4, 4)
    want = np.asarray(y).transpose(0, 3, 1, 2)
    assert_max_abs(got, want, TOL * _scaled(want), "VisionTransformer")
    got_g = torch.autograd.grad(got, list(port.parameters()), _nchw(cot))
    _check_grads(port, got_g, grads, lambda t: _converted(lambda c: c.vit("m", ""), t))


def test_vision_transformer_decoder_matches_jax():
    rng = np.random.default_rng(3)
    tokens = rng.normal(size=(2, 3, 2, 16)).astype(np.float32)
    jm = jax_vit.VisionTransformerDecoder(patch_size=4, embed_dim=16, depth=2, num_heads=2)
    params = random_params(jm, tokens)
    want = np.asarray(jm.apply({"params": params}, tokens))

    def fill(c):
        c.vit_blocks("m", "")
        c.layernorm("m/norm", "norm")
        c.dense("m/pred", "pred")

    port = load_port(vit.VisionTransformerDecoder(patch_size=4, embed_dim=16, depth=2,
                                                  num_heads=2), _converted(fill, params))
    got = port(_nchw(tokens))
    assert got.shape == want.shape == (2, 12, 8, 3)
    assert_max_abs(got, want, TOL * _scaled(want), "VisionTransformerDecoder")


def test_full_vit_b_forward_matches_jax():
    """ViT-B at its defaults, 12 x 768, 12 heads, background 32 (4 tokens)."""
    x = np.random.default_rng(4).normal(size=(1, 32, 32, 3)).astype(np.float32)
    jm = jax_vit.VisionTransformer()
    params, sd = _vit_params_case(jm, x)
    want = np.asarray(jax.jit(lambda p: jm.apply({"params": p}, x))(params)).transpose(0, 3, 1, 2)
    port = load_port(vit.VisionTransformer(32), sd)
    # 12 blocks of 7,087,872, the patch embedding 590,592, 4 pos tokens, the last norm
    assert sum(p.numel() for p in port.parameters()) == 85_649_664
    with torch.no_grad():
        got = port(_nchw(x))
    assert got.shape == (1, 768, 2, 2)
    assert_max_abs(got, want, TOL * _scaled(want), "ViT-B")


def test_converter_raises_on_missing_and_extra_vit_leaves():
    x = np.zeros((1, 32, 32, 3), np.float32)
    params = {"backbone": random_params(jax_vit.VisionTransformer(**NARROW), x)}
    missing = jax.tree.map(lambda a: a, params)
    del missing["backbone"]["blocks_1"]["fc2"]["bias"]
    with pytest.raises(KeyError, match="blocks_1/fc2/bias"):
        JaxParams(missing).vit("backbone", "backbone")
    extra = jax.tree.map(lambda a: a, params)
    extra["backbone"]["blocks_0"]["ls1"] = {"gamma": np.ones(16, np.float32)}
    c = JaxParams(extra)
    c.vit("backbone", "backbone")
    with pytest.raises(KeyError, match="ls1"):
        c.finish()


# ---------------------------------------------------------------------------
# G and D with backbone='vit'
# ---------------------------------------------------------------------------

class _NarrowJaxViT(jax_vit.VisionTransformer):
    embed_dim: int = NARROW["embed_dim"]
    depth: int = NARROW["depth"]
    num_heads: int = NARROW["num_heads"]


@pytest.fixture
def narrow_vit(monkeypatch):
    monkeypatch.setattr(jax_vit, "VisionTransformer", _NarrowJaxViT)
    monkeypatch.setattr(port_generator, "VisionTransformer",
                        functools.partial(vit.VisionTransformer, **NARROW))


def _batch(cfg, b=2, seed=0, generator=True):
    rng = np.random.default_rng(seed)
    n, t = cfg.max_elements, cfg.max_text_length
    mask = np.ones((b, n, t), np.int32)
    lens = rng.integers(2, t + 1, size=(b, n))
    mask[np.arange(t)[None, None, :] >= lens[..., None]] = 0
    pad = np.zeros((b, n), bool)
    pad[0, 4:] = True
    pad[1, 7:] = True
    out = dict(
        bbox_class=rng.integers(0, cfg.num_bbox_labels, size=(b, n)),
        text_ids=rng.integers(1, cfg.vocab_size, size=(b, n, t)) * mask,
        text_mask=mask,
        text_len=rng.integers(0, cfg.text_len_table + 10, size=(b, n)),
        padding_mask=pad,
        background=rng.normal(size=(b, cfg.background_size, cfg.background_size, 3)).astype(
            np.float32),
    )
    boxes = rng.uniform(0.1, 0.9, size=(b, n, 4)).astype(np.float32)
    if generator:
        return dict(z=rng.normal(size=(b, n, cfg.z_dim)).astype(np.float32), bbox_real=boxes,
                    **out)
    return dict(bbox=boxes, **out)


def _scalar(outs, cots):
    """A fixed scalar of a model's outputs: each output against its cotangent."""
    return sum((o.astype(jnp.float32) * c).sum() if hasattr(o, "astype") else
               (o.float() * torch.from_numpy(c)).sum() for o, c in zip(outs, cots))


def _cotangents(outs, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=o.shape).astype(np.float32) for o in outs]


VIT_CFG = dict(backbone="vit", background_size=32, reconst_decoder_layers=1,
               uncond_encoder_layers=1)


@pytest.mark.parametrize("model", ["G", "D"])
@pytest.mark.parametrize("reconst", [False, True])
def test_vit_models_and_grads_match_jax(narrow_vit, model, reconst):
    """Outputs, and the gradient of a fixed scalar of them with respect to
    every parameter (the JAX gradient tree carried across by the same
    converter); background 32, a 2 x 2 DETR memory (the ResNet's is 1 x 1)."""
    jcfg, cfg = tiny_configs(**VIT_CFG)
    if model == "G":
        jm, port, convert = JaxGenerator(jcfg), Generator(cfg), generator_state_dict_from_jax
    else:
        jm, port, convert = JaxDiscriminator(jcfg), Discriminator(cfg), \
            discriminator_state_dict_from_jax
    batch = _batch(jcfg, generator=model == "G")
    params = random_params(jm, **batch, reconst=True)
    assert "blocks_1" in params["backbone"] and "layer1_0" not in params["backbone"]

    def run(p):
        out = jm.apply({"params": p}, **batch, reconst=reconst)
        return out if isinstance(out, tuple) else (out,)

    cots = _cotangents(jax.eval_shape(run, params), 5)
    (_, want), jgrads = jax.jit(jax.value_and_grad(lambda p: (_scalar(run(p), cots), run(p)),
                                                   has_aux=True))(params)
    want = [np.asarray(a) for a in want]

    port = load_port(port, convert(params, cfg))
    got = port(**{k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}, reconst=reconst)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape, i
        assert_max_abs(g, w, TOL * _scaled(w), f"{model} output {i}")
    params_list = list(port.parameters())
    got_g = torch.autograd.grad(_scalar(got, cots), params_list, allow_unused=True)
    _check_grads(port, got_g, jgrads, lambda t: convert(t, cfg))


def test_frozen_set_under_vit_equals_jax(narrow_vit):
    """JAX freezes by substring (``text_encoder``, ``backbone/conv1``, ...),
    none of which names a ViT leaf: the whole ViT trains and only BERT is
    frozen. The port's requires_grad, per converted leaf, is the same."""
    jcfg, cfg = tiny_configs(**VIT_CFG)
    for jm, port, convert, subs in (
            (JaxGenerator(jcfg), Generator(cfg), generator_state_dict_from_jax,
             jax_opt.G_FROZEN_SUBSTRINGS),
            (JaxDiscriminator(jcfg), Discriminator(cfg), discriminator_state_dict_from_jax,
             jax_opt.D_FROZEN_SUBSTRINGS)):
        batch = _batch(jcfg, generator=isinstance(jm, JaxGenerator))
        params = random_params(jm, **batch, reconst=True)
        labels = jax_opt.freeze_mask(params, subs)
        # the labels as leaves of the params' shapes, through the converter
        frozen = convert(jax.tree.map(lambda lab, p: np.full(p.shape, lab == "freeze", np.float32),
                                      labels, params), cfg)
        freeze(port)
        seen = 0
        for name, p in port.named_parameters():
            if ".crossattention." in name:  # filled (JAX has none): frozen with their encoder
                continue
            want_frozen = bool(frozen[name].flatten()[0])
            assert p.requires_grad != want_frozen, name
            seen += 1
        assert seen == len(jax.tree.leaves(params))
        assert not any(p.requires_grad for n, p in port.named_parameters()
                       if n.startswith("text_encoder."))
        assert all(p.requires_grad for n, p in port.named_parameters() if n.startswith("backbone."))
