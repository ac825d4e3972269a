"""The port's LayoutGAN++ pair (``models/layoutganpp.py``) vs the JAX
package's, on the same numpy inputs with the JAX params carried across by
``layoutganpp_{generator,discriminator}_state_dict_from_jax``: G, and D
with ``reconst`` False and True, at T=40 (the variant's text length),
background 32, narrow widths (f_dim 16, 2 heads, 2 layers, BERT 32 wide).

fp32: outputs and the gradients of a fixed scalar of them with respect to
every parameter, 1e-5 max-abs, relative above 1 (``loss_lm`` so 1e-5
relative). The inputs come from seed 3: at seed 0 one pre-activation of
D's bg_decoder lies 1.6e-7 from lrelu's kink, fp32 rounding puts the port
on the other side of it than JAX and float64 (a slope of 0.2 for 1), and
the decoder's gradients then differ by 6e-4 of their size; away from a
kink they agree to 1e-6 with float64.

bf16 forward, both sides in bf16 on the same fp32 params: the boxes,
logits and ``loss_lm`` within 2e-2 of max(1, max |y|) of JAX's bf16 (the
port's bf16 attention bar); ``bg_rec`` (values up to ~4 through the
decoder's 8 lrelu FCs and 6 modulated convs, where JAX's own bf16 lay
2.7% from its fp32 at seed 0) within 5e-2 of max |y| of JAX's fp32, the bar
chip_smoke.py holds a bf16 model to its fp32 twin at.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from layoutdetr_tpu.models.layoutganpp import LayoutGanPPConfig as JaxConfig
from layoutdetr_tpu.models.layoutganpp import LayoutGanPPDiscriminator as JaxD
from layoutdetr_tpu.models.layoutganpp import LayoutGanPPGenerator as JaxG
from layoutdetr_tpu_torch.models.layoutganpp import (
    LayoutGanPPConfig,
    LayoutGanPPDiscriminator,
    LayoutGanPPGenerator,
)
from layoutdetr_tpu_torch.utils.convert import (
    layoutganpp_discriminator_state_dict_from_jax,
    layoutganpp_generator_state_dict_from_jax,
)

from test_torch_common import TINY_KW, assert_max_abs, load_port, random_params
from test_torch_common import one_torch_thread  # noqa: F401 (module-scoped autouse fixture)
from test_torch_vit import _check_grads, _cotangents, _scalar, _scaled

TOL = 1e-5
BF16_TOL = 2e-2
BF16_VS_FP32_TOL = 5e-2
SEED = 3
KW = {**TINY_KW, "max_text_length": 40, "bert_max_position_embeddings": 64, "f_dim": 16,
      "num_heads": 2, "num_layers": 2}


def _configs():
    jcfg = JaxConfig(**KW)
    return jcfg, LayoutGanPPConfig.from_dict(dataclasses.asdict(jcfg))


def _batch(cfg, generator, b=2, seed=SEED):
    rng = np.random.default_rng(seed)
    n, t = cfg.max_elements, cfg.max_text_length
    mask = np.ones((b, n, t), np.int32)
    lens = rng.integers(2, t + 1, size=(b, n))
    mask[np.arange(t)[None, None, :] >= lens[..., None]] = 0
    pad = np.zeros((b, n), bool)
    pad[0, 3:] = True
    pad[1, 8:] = True
    out = dict(
        bbox_class=rng.integers(0, cfg.num_bbox_labels, size=(b, n)),
        text_ids=rng.integers(1, cfg.vocab_size, size=(b, n, t)) * mask,
        text_mask=mask,
        text_len=rng.integers(0, 120, size=(b, n)),  # len / 40 runs past 1
        padding_mask=pad,
        background=rng.normal(size=(b, cfg.background_size, cfg.background_size, 3)).astype(
            np.float32),
    )
    boxes = rng.uniform(0.1, 0.9, size=(b, n, 4)).astype(np.float32)
    if generator:
        return dict(z=rng.normal(size=(b, n, cfg.z_dim)).astype(np.float32), bbox_real=boxes,
                    **out)
    return dict(bbox=boxes, **out)


def _models(model):
    jcfg, cfg = _configs()
    if model == "G":
        return jcfg, cfg, JaxG(jcfg), LayoutGanPPGenerator, \
            layoutganpp_generator_state_dict_from_jax, {}
    return jcfg, cfg, JaxD(jcfg), LayoutGanPPDiscriminator, \
        layoutganpp_discriminator_state_dict_from_jax, {"reconst": True}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("model,reconst", [("G", None), ("D", False), ("D", True)])
def test_layoutganpp_and_grads_match_jax(model, reconst):
    jcfg, cfg, jm, port_cls, convert, init_kw = _models(model)
    batch = _batch(jcfg, generator=model == "G")
    params = random_params(jm, **batch, **init_kw, seed=SEED)
    call_kw = {} if reconst is None else {"reconst": reconst}

    def run(p):
        out = jm.apply({"params": p}, **batch, **call_kw)
        return out if isinstance(out, tuple) else (out,)

    cots = _cotangents(jax.eval_shape(run, params), 7)
    (_, want), jgrads = jax.jit(jax.value_and_grad(lambda p: (_scalar(run(p), cots), run(p)),
                                                   has_aux=True))(params)
    want = [np.asarray(a) for a in want]
    assert len(want) == (4 if reconst else 1)

    port = load_port(port_cls(cfg), convert(params, cfg))
    got = port(**_torch(batch), **call_kw)
    got = got if isinstance(got, tuple) else (got,)
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, i
        assert_max_abs(g, w, TOL * _scaled(w), f"{model} output {i}")
    if reconst:
        assert got[3].shape == batch["background"].shape  # bg_rec channels last
    grads = torch.autograd.grad(_scalar(got, cots), list(port.parameters()), allow_unused=True)
    _check_grads(port, grads, jgrads, lambda t: convert(t, cfg))


def _outputs(jm, params, batch, kw):
    out = jax.jit(lambda p: jm.apply({"params": p}, **batch, **kw))(params)
    return [np.asarray(a, np.float32) for a in (out if isinstance(out, tuple) else (out,))]


def test_layoutganpp_bf16_matches_jax():
    """G and D(reconst=True) in bf16 on both sides, the same fp32 params."""
    for model in ("G", "D"):
        jcfg, cfg, _, port_cls, convert, init_kw = _models(model)
        jm = (JaxG if model == "G" else JaxD)(jcfg, dtype=jnp.bfloat16)
        batch = _batch(jcfg, generator=model == "G")
        params = random_params(jm, **batch, **init_kw, seed=SEED)
        want, want32 = (_outputs(m, params, batch, init_kw) for m in (jm, _models(model)[2]))
        port = load_port(port_cls(cfg, dtype=torch.bfloat16), convert(params, cfg))
        with torch.no_grad():
            got = port(**_torch(batch), **init_kw)
        got = got if isinstance(got, tuple) else (got,)
        for i, (g, w, w32) in enumerate(zip(got, want, want32)):
            assert tuple(g.shape) == w.shape, (model, i)
            if model == "D" and i == 3:  # bg_rec
                assert_max_abs(g.float(), w32, BF16_VS_FP32_TOL * np.abs(w32).max(),
                               "bf16 bg_rec vs JAX fp32")
            else:
                assert_max_abs(g.float(), w, BF16_TOL * _scaled(w), f"bf16 {model} output {i}")


def test_text_length_feature_is_len_over_40_whatever_t():
    """At T=16 the feature is still len / 40 (JAX's choice, kept): G's
    output follows text_len the same way on both sides."""
    jcfg, cfg = _configs()
    jcfg, cfg = (dataclasses.replace(c, max_text_length=16, text_len_table=16)
                 for c in (jcfg, cfg))
    batch = _batch(jcfg, generator=True)
    params = random_params(JaxG(jcfg), **batch, seed=SEED)
    port = load_port(LayoutGanPPGenerator(cfg), layoutganpp_generator_state_dict_from_jax(params,
                                                                                        cfg))
    for text_len in (batch["text_len"], batch["text_len"] * 3):
        b = dict(batch, text_len=text_len)
        want = np.asarray(JaxG(jcfg).apply({"params": params}, **b))
        with torch.no_grad():
            assert_max_abs(port(**_torch(b)), want, TOL, "bbox at T=16")


def test_converters_raise_on_missing_and_extra_leaves():
    jcfg, cfg = _configs()
    for model in ("G", "D"):
        _, _, jm, _, convert, init_kw = _models(model)
        params = random_params(jm, **_batch(jcfg, generator=model == "G"), **init_kw)
        missing = jax.tree.map(lambda a: a, params)
        del missing["bg_encoder"]["b32"]["conv1"]["bias"]
        with pytest.raises(KeyError, match="bg_encoder/b32/conv1/bias"):
            convert(missing, cfg)
        extra = jax.tree.map(lambda a: a, params)
        extra["bg_encoder"]["b32"]["skip"]["bias"] = np.zeros(16, np.float32)  # the skip has none
        with pytest.raises(KeyError, match="b32/skip/bias"):
            convert(extra, cfg)
