"""The LayoutGAN++ generator and discriminator (the legacy, non-DETR variant).

Counterpart of ``layoutdetr_tpu/models/layoutganpp.py`` (reference
training/networks_layoutganpp.py:38-211): the background goes through a
StyleGAN2 ``Encoder`` into one global feature (no spatial
cross-attention), element tokens through plain torch encoder layers, the
text length enters as the scalar ``len / 40`` and the text is cut at 40
tokens. As in JAX there is no CLI and no train step for it.

Two choices of the JAX module are kept as they are, odd as they look: the
text-length feature divides by 40 whatever T is, and D's ``text_decoder``
runs in mode='text', an unconditional LM that never reads the
per-element features it is handed in JAX (``encoder_hidden_states``).
The encoders are built with ``conv_clamp=None`` (``Encoder`` defaults to
256).

Parameter names are the JAX tree's, dotted (the reference's state dict is
not in the repository): ``fc_z``, ``text_encoder.*``, ``bg_encoder.b{res}.*``,
``fc_in``, ``transformer_layers.{i}``, ``fc_out``; D's ``fc_bbox``,
``enc_fc_in``, ``enc_transformer.{token,core.layers.{i}}``,
``fc_out_disc``, ``pos_token`` [max_bbox, f_dim], ``dec_fc_in``,
``dec_layers.{i}``, ``fc_out_bbox``, ``text_decoder.*`` and
``bg_decoder.*``. Inputs are the LayoutDETR models' (background
[B, S, S, 3] channels last, texts [B, N, T]); the frozen-encoder pass
takes the fused attention kernel when no gradient is recorded.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from layoutdetr_tpu_torch.config import GeneratorConfig
from layoutdetr_tpu_torch.models.bert import BertLMHeadModel, TextEncoder
from layoutdetr_tpu_torch.models.detr_transformer import (
    TorchEncoderLayer,
    TransformerWithTokenEncoder,
)
from layoutdetr_tpu_torch.models.generator import text_reconstruction_loss
from layoutdetr_tpu_torch.models.layers import Dense, padding_bias
from layoutdetr_tpu_torch.models.stylegan2 import Decoder, Encoder, normalize_2nd_moment

TEXT_LEN_SCALE = 40.0  # networks_layoutganpp.py:84


@dataclasses.dataclass(frozen=True)
class LayoutGanPPConfig(GeneratorConfig):
    f_dim: int = 256
    num_heads: int = 4
    num_layers: int = 8
    max_text_length: int = 40  # networks_layoutganpp.py:82 tokenizes at 40


def _bg_encoder(cfg: LayoutGanPPConfig, dtype) -> Encoder:
    return Encoder(cfg.background_size, cfg.im_f_dim, channel_base=8192,
                   channel_max=cfg.im_f_dim, conv_clamp=None, dtype=dtype)


def _stack(cfg: LayoutGanPPConfig, dtype) -> nn.ModuleList:
    return nn.ModuleList(TorchEncoderLayer(cfg.im_f_dim, cfg.num_heads, cfg.im_f_dim, dtype=dtype)
                         for _ in range(cfg.num_layers))


def _features(module, text_ids, text_mask, text_len, background, deterministic, generator):
    """The text CLS features, the ``len / 40`` feature and the background's
    global feature broadcast over the N elements, all in the run's dtype."""
    b, n, _ = text_ids.shape
    text_feat = module.text_encoder(text_ids, text_mask, deterministic, generator)
    tl = (text_len.float() / TEXT_LEN_SCALE)[..., None].to(module.dtype)
    # NCHW in memory too: a conv of the permuted view returns a channels-last
    # map, which bias_act would copy before its kernel
    bg = module.bg_encoder(background.permute(0, 3, 1, 2).contiguous())
    bg = bg[:, None, :].expand(b, n, bg.shape[-1]).to(module.dtype)
    return text_feat, tl, bg


class LayoutGanPPGenerator(nn.Module):
    """z + texts + background -> bboxes [B, N, 4] fp32 in (0, 1)."""

    def __init__(self, cfg: LayoutGanPPConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.fc_z = Dense(cfg.max_elements * cfg.z_dim, cfg.f_dim // 2, dtype=dtype)
        self.text_encoder = TextEncoder(cfg.encoder_bert_config(), dtype=dtype)
        self.bg_encoder = _bg_encoder(cfg, dtype)
        self.fc_in = Dense(cfg.f_dim // 2 + cfg.bert_f_dim + 1 + cfg.im_f_dim, cfg.im_f_dim,
                           dtype=dtype)
        self.transformer_layers = _stack(cfg, dtype)
        self.fc_out = Dense(cfg.im_f_dim, 4, dtype=dtype)

    def forward(self, z, bbox_class, bbox_real, text_ids, text_mask, text_len, padding_mask,
                background, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """Arguments as ``Generator.forward``'s (bbox_class only gives N;
        bbox_real is unused)."""
        del bbox_real
        b, n = bbox_class.shape
        zf = self.fc_z(normalize_2nd_moment(z.reshape(b, -1).float()))
        zf = zf[:, None, :].expand(b, n, zf.shape[-1])
        text_feat, tl, bg = _features(self, text_ids, text_mask, text_len, background,
                                      deterministic, generator)
        x = F.relu(self.fc_in(torch.cat([zf, text_feat, tl, bg], dim=-1)))
        bias = padding_bias(padding_mask)
        for layer in self.transformer_layers:
            x = layer(x, bias, deterministic, generator)
        return torch.sigmoid(self.fc_out(x).float())


class LayoutGanPPDiscriminator(nn.Module):
    """(bbox, texts, background) -> logit [B]; with ``reconst`` also
    (bbox_pred [B, N, 4], loss_lm, bg_rec [B, S, S, 3])."""

    def __init__(self, cfg: LayoutGanPPConfig, max_bbox: int = 50,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.im_f_dim
        self.fc_bbox = Dense(4, cfg.f_dim // 2, dtype=dtype)
        self.text_encoder = TextEncoder(cfg.encoder_bert_config(), dtype=dtype)
        self.bg_encoder = _bg_encoder(cfg, dtype)
        self.enc_fc_in = Dense(cfg.f_dim // 2 + cfg.bert_f_dim + 1 + d, d, dtype=dtype)
        self.enc_transformer = TransformerWithTokenEncoder(d, cfg.num_heads, d, cfg.num_layers,
                                                           dtype=dtype)
        self.fc_out_disc = Dense(d, 1, dtype=dtype)
        self.pos_token = nn.Parameter(torch.rand(max_bbox, cfg.f_dim))
        self.dec_fc_in = Dense(d + cfg.f_dim, d, dtype=dtype)
        self.dec_layers = _stack(cfg, dtype)
        self.fc_out_bbox = Dense(d, 4, dtype=dtype)
        self.text_decoder = BertLMHeadModel(cfg.decoder_bert_config(), dtype=dtype)
        self.bg_decoder = Decoder(z_dim=d, w_dim=d, img_resolution=cfg.background_size,
                                  img_channels=3, channel_base=8192, channel_max=d,
                                  conv_clamp=None, dtype=dtype)

    def forward(self, bbox, bbox_class, text_ids, text_mask, text_len, padding_mask, background,
                reconst: bool = False, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        b, n = bbox_class.shape
        bf = self.fc_bbox(bbox.to(self.dtype))
        text_feat, tl, bg = _features(self, text_ids, text_mask, text_len, background,
                                      deterministic, generator)
        x = F.relu(self.enc_fc_in(torch.cat([bf, text_feat, tl, bg], dim=-1)))
        x = self.enc_transformer(x, padding_mask, deterministic, generator)
        x0 = x[:, 0, :]
        logit_disc = self.fc_out_disc(x0)[..., 0].float()
        if not reconst:
            return logit_disc

        xx = x0[:, None, :].expand(b, n, x0.shape[-1])
        t = self.pos_token[None, :n, :].expand(b, n, self.pos_token.shape[-1]).to(xx.dtype)
        xx = F.relu(self.dec_fc_in(torch.cat([xx, t], dim=-1)))
        bias = padding_bias(padding_mask)
        for layer in self.dec_layers:
            xx = layer(xx, bias, deterministic, generator)
        bbox_pred = torch.sigmoid(self.fc_out_bbox(xx).float())
        # mode='text': the decoder never reads xx (JAX hands it over unused)
        loss_lm = text_reconstruction_loss(self.text_decoder, self.cfg, text_ids, text_mask,
                                           ~padding_mask, deterministic, generator)
        bg_rec = self.bg_decoder(x0)
        return logit_disc, bbox_pred, loss_lm, bg_rec
