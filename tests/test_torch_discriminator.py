"""Port Discriminator vs the JAX package's, at reconst=False (the critics)
and reconst=True (the Dreal pass: reconstruction decoders, text decoder,
text-length head, bg_decoder), deterministic, with the hoisted text
features and without; and the state dict read back through the JAX
package's ``convert_discriminator`` (the reference's names).

Tiny widths (TINY_KW) but the depths ``convert_discriminator`` hard-codes
(ResNet50 (3, 4, 6, 3), 6 unconditional and 6 reconstruction layers).
fp32; 1e-5 max-abs, relative above 1 for outputs that exceed it (the
background reconstruction reaches ~5)."""

import numpy as np
import pytest
import torch

import jax

from layoutdetr_tpu.models.discriminator import Discriminator as JaxDiscriminator
from layoutdetr_tpu.models.generator import make_text_feature_fn as jax_text_feature_fn
from layoutdetr_tpu.utils import torch_convert
from layoutdetr_tpu_torch.models.discriminator import Discriminator
from layoutdetr_tpu_torch.models.generator import make_text_feature_fn
from layoutdetr_tpu_torch.utils.convert import discriminator_state_dict_from_jax

from test_torch_common import assert_max_abs, load_port, random_params, tiny_configs
from test_torch_common import one_torch_thread  # noqa: F401 (module-scoped autouse fixture)

NAMES = ("logit_disc", "logit_disc_uncond", "bbox_pred", "logit_cls", "loss_lm", "loss_text_len",
         "bg_rec", "bbox_pred_uncond", "logit_cls_uncond")


def _batch(cfg, b=2, seed=0):
    rng = np.random.default_rng(seed)
    n, t = cfg.max_elements, cfg.max_text_length
    mask = np.ones((b, n, t), np.int32)
    lens = rng.integers(2, t + 1, size=(b, n))
    mask[np.arange(t)[None, None, :] >= lens[..., None]] = 0
    pad = np.zeros((b, n), bool)
    pad[0, 3:] = True
    pad[1, 7:] = True
    return dict(
        bbox=rng.uniform(0.1, 0.9, (b, n, 4)).astype(np.float32),
        bbox_class=rng.integers(0, cfg.num_bbox_labels, (b, n)),
        text_ids=rng.integers(1, cfg.vocab_size, (b, n, t)) * mask,
        text_mask=mask,
        text_len=rng.integers(0, cfg.text_len_table + 10, (b, n)),
        padding_mask=pad,
        background=rng.normal(size=(b, cfg.background_size, cfg.background_size, 3)).astype(np.float32),
    )


@pytest.fixture(scope="module")
def case():
    jcfg, cfg = tiny_configs(backbone_stage_sizes=(3, 4, 6, 3))
    batch = _batch(jcfg)
    params = random_params(JaxDiscriminator(jcfg), reconst=True, **batch)
    jd = JaxDiscriminator(jcfg)
    want = {r: [np.asarray(a) for a in jd.apply({"params": params}, reconst=r, **batch)]
            for r in (False, True)}
    port = load_port(Discriminator(cfg), discriminator_state_dict_from_jax(params, cfg))
    return jcfg, cfg, batch, params, want, port


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("reconst", [False, True])
def test_discriminator_matches_jax(case, reconst):
    _, _, batch, _, want, port = case
    with torch.no_grad():
        got = port(**_torch(batch), reconst=reconst)
    assert len(got) == len(want[reconst]) == (9 if reconst else 2)
    for name, g, w in zip(NAMES, got, want[reconst]):
        assert tuple(g.shape) == w.shape, name
        assert_max_abs(g, w, 1e-5 * max(1.0, float(np.abs(w).max())), name)
    if reconst:
        assert got[6].shape == batch["background"].shape  # bg_rec is channels last


def test_discriminator_hoisted_text_feat(case):
    """The train step's path: D takes the shared text features."""
    jcfg, _, batch, params, want, port = case
    tf = jax_text_feature_fn(jcfg, flash=False)(params["text_encoder"], batch["text_ids"],
                                                 batch["text_mask"])
    tb = _torch(batch)
    port_tf = make_text_feature_fn(port.text_encoder)(tb["text_ids"], tb["text_mask"])
    assert_max_abs(port_tf, np.asarray(tf), 1e-5, "text_feat")
    with torch.no_grad():
        got = port(**tb, text_feat=port_tf)
    for name, g, w in zip(NAMES, got, want[False]):
        assert_max_abs(g, w, 1e-5, f"{name} with text_feat")


def _drop_crossattention(tree):
    if not isinstance(tree, dict):
        return tree
    return {k: _drop_crossattention(v) for k, v in tree.items() if k != "crossattention"}


def test_state_dict_reads_back_through_convert_discriminator(case):
    """The JAX package's torch converter takes the port's state dict to
    the JAX params it came from: the names and layouts are the
    reference's networks_detr ones."""
    _, cfg, _, params, _, port = case
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = torch_convert.convert_discriminator(
        sd, cfg.num_encoder_layers, cfg.num_decoder_layers, cfg.bert_num_encoder_layers,
        cfg.bert_num_decoder_layers, cfg.vocab_size)
    # the port holds crossattention blocks JAX creates only in mode='multimodal'
    back = _drop_crossattention(back)
    assert set(back) == set(params)
    jax.tree.map(np.testing.assert_array_equal, back, params)
