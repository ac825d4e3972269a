"""LayoutDETR Discriminator: conditional and unconditional critics with
reconstruction decoders.

Counterpart of ``layoutdetr_tpu/models/discriminator.py`` (reference
networks_detr.py:190-361):

- conditional critic: its own ResNet50 + per-element (bbox, label, text,
  text-length) features -> DETR ``Transformer(with_token=True)`` -> the
  CLS logit;
- unconditional critic: (bbox, label) -> ``TransformerWithTokenEncoder``
  -> the CLS logit;
- with ``reconst=True`` (the Dreal pass): the reconstruction decoders
  (learned ``pos_token`` + ``dec_fc_in`` + torch encoder layers)
  regressing boxes and labels, the BERT LM text decoder, the text-length
  head and the StyleGAN2 ``bg_decoder`` rebuilding the background from the
  CLS feature.

Parameter names and layouts are the reference's (``fc_bbox``,
``enc_transformer.token``, ``enc_transformer_uncond.core.layers.{i}``,
``pos_token`` [max_bbox, 1, D], ``dec_fc_in``, ``dec_transformer.layers.{i}``,
``bg_decoder.synthesis.b{r}`` ...), which the JAX package's
``convert_discriminator`` reads. The text features come hoisted
(``text_feat``) in training; otherwise D's own frozen ``text_encoder``
runs.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from layoutdetr_tpu_torch.config import GeneratorConfig
from layoutdetr_tpu_torch.metrics.layout_metrics import masked_cross_entropy
from layoutdetr_tpu_torch.models.bert import BertLMHeadModel, TextEncoder
from layoutdetr_tpu_torch.models.detr_transformer import (
    TorchEncoderLayer,
    Transformer,
    TransformerWithTokenEncoder,
    _Stack,
)
from layoutdetr_tpu_torch.models.generator import _BackboneBody, text_reconstruction_loss
from layoutdetr_tpu_torch.models.layers import MLP, Dense, padding_bias
from layoutdetr_tpu_torch.models.position_encoding import position_embedding_sine
from layoutdetr_tpu_torch.models.stylegan2 import Decoder


def reconst_decode(x0, padding_mask, pos_token, fc_in: Dense, stack: _Stack,
                   deterministic=True, generator=None):
    """CLS feature + learned positional tokens -> per-element features
    (networks_detr.py:239-243, 315-321; JAX ``_ReconstDecoder``).
    x0: [B, D]; pos_token: [max_bbox, 1, D]."""
    b, d = x0.shape
    n = padding_mask.shape[1]
    x = x0[:, None, :].expand(b, n, d)
    t = pos_token[:n, 0, :][None].expand(b, n, pos_token.shape[-1]).to(x.dtype)
    x = F.relu(fc_in(torch.cat([x, t], dim=-1)))
    bias = padding_bias(padding_mask)
    for layer in stack.layers:
        x = layer(x, bias, deterministic, generator)
    return x


class Discriminator(nn.Module):
    def __init__(self, cfg: GeneratorConfig, max_bbox: int = 50, dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.backbone != "resnet50":
            raise NotImplementedError(f"backbone {cfg.backbone!r} is not ported yet")
        self.cfg = cfg
        self.dtype = dtype
        d, f = cfg.hidden_dim, cfg.bert_f_dim
        # conditional critic
        self.backbone = nn.ModuleList([_BackboneBody(cfg.backbone_stage_sizes, dtype)])
        self.input_proj = nn.Conv2d(2048, d, kernel_size=1)
        self.fc_bbox = Dense(4, f, dtype=dtype)
        self.emb_label = nn.Embedding(cfg.num_bbox_labels, f)
        self.text_encoder = TextEncoder(cfg.encoder_bert_config(), dtype=dtype)
        self.enc_text_len = nn.Embedding(cfg.text_len_table, f)
        self.enc_fc_in = MLP(4 * f, f, d, 3, dtype=dtype)
        self.enc_transformer = Transformer(d, cfg.nhead, cfg.num_encoder_layers,
                                           cfg.num_decoder_layers, cfg.dim_feedforward,
                                           cfg.dropout, with_token=True, dtype=dtype)
        self.fc_out_disc = Dense(d, 1, dtype=dtype)
        # unconditional critic
        self.fc_bbox_uncond = Dense(4, f, dtype=dtype)
        self.emb_label_uncond = nn.Embedding(cfg.num_bbox_labels, f)
        self.enc_fc_in_uncond = MLP(2 * f, f, d, 3, dtype=dtype)
        self.enc_transformer_uncond = TransformerWithTokenEncoder(
            d, cfg.nhead, cfg.dim_feedforward, cfg.uncond_encoder_layers, dtype=dtype)
        self.fc_out_disc_uncond = Dense(d, 1, dtype=dtype)
        # conditional reconstruction decoders
        self.pos_token = nn.Parameter(torch.rand(max_bbox, 1, d))
        self.dec_fc_in = Dense(2 * d, d, dtype=dtype)
        self.dec_transformer = self._reconst_stack(cfg, dtype)
        self.bbox_embed = Dense(d, 4, dtype=dtype)
        self.fc_out_cls = Dense(d, cfg.num_bbox_labels, dtype=dtype)
        self.text_decoder = BertLMHeadModel(cfg.decoder_bert_config(), dtype=dtype)
        self.fc_text_len_rec = Dense(d, cfg.text_len_table, dtype=dtype)
        self.bg_decoder = Decoder(z_dim=d, w_dim=cfg.im_f_dim, img_resolution=cfg.background_size,
                                  img_channels=3, channel_base=8192, channel_max=cfg.im_f_dim,
                                  conv_clamp=None, dtype=dtype)
        # unconditional reconstruction decoders
        self.pos_token_uncond = nn.Parameter(torch.rand(max_bbox, 1, d))
        self.dec_fc_in_uncond = Dense(2 * d, d, dtype=dtype)
        self.dec_transformer_uncond = self._reconst_stack(cfg, dtype)
        self.bbox_embed_uncond = Dense(d, 4, dtype=dtype)
        self.fc_out_cls_uncond = Dense(d, cfg.num_bbox_labels, dtype=dtype)

    @staticmethod
    def _reconst_stack(cfg: GeneratorConfig, dtype) -> _Stack:
        return _Stack(TorchEncoderLayer(cfg.hidden_dim, cfg.nhead, cfg.dim_feedforward, dtype=dtype)
                      for _ in range(cfg.reconst_decoder_layers))

    def forward(self, bbox, bbox_class, text_ids, text_mask, text_len, padding_mask, background,
                reconst: bool = False, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                text_feat: Optional[torch.Tensor] = None):
        """bbox: [B, N, 4]; the rest as in ``Generator.forward``. Returns
        (logit_disc [B], logit_disc_uncond [B]) or, with ``reconst``,
        (logit_disc, logit_disc_uncond, bbox_pred, logit_cls, loss_lm,
        loss_text_len, bg_rec [B, S, S, 3], bbox_pred_uncond,
        logit_cls_uncond)."""
        cfg, dt = self.cfg, self.dtype
        kw = dict(deterministic=deterministic, generator=generator)
        valid = ~padding_mask

        # conditional critic (networks_detr.py:282-300)
        feat = self.backbone[0].body(background.permute(0, 3, 1, 2))
        proj = F.conv2d(feat.to(dt), self.input_proj.weight.to(dt), self.input_proj.bias.to(dt))
        pos = position_embedding_sine(feat.permute(0, 2, 3, 1), cfg.hidden_dim // 2)
        bf = self.fc_bbox(bbox.to(dt))
        lf = self.emb_label(bbox_class).to(dt)
        if text_feat is None:
            text_feat = self.text_encoder(text_ids, text_mask, deterministic, generator)
        tlf = self.enc_text_len(text_len.clamp(0, cfg.text_len_table - 1)).to(dt)
        x = F.relu(self.enc_fc_in(torch.cat([bf, lf, text_feat.to(dt), tlf], dim=-1)))
        hs, _ = self.enc_transformer(proj.permute(0, 2, 3, 1), pos, x, padding_mask, **kw)
        x0 = hs[:, 0, :]
        logit_disc = self.fc_out_disc(x0)[..., 0].float()

        # unconditional critic (networks_detr.py:302-309)
        bfu = self.fc_bbox_uncond(bbox.to(dt))
        lfu = self.emb_label_uncond(bbox_class).to(dt)
        xu = F.relu(self.enc_fc_in_uncond(torch.cat([bfu, lfu], dim=-1)))
        x0_uncond = self.enc_transformer_uncond(xu, padding_mask, **kw)[:, 0, :]
        logit_disc_uncond = self.fc_out_disc_uncond(x0_uncond)[..., 0].float()
        if not reconst:
            return logit_disc, logit_disc_uncond

        # conditional reconstruction (networks_detr.py:314-349)
        feats = reconst_decode(x0, padding_mask, self.pos_token, self.dec_fc_in,
                               self.dec_transformer, **kw)
        bbox_pred = torch.sigmoid(self.bbox_embed(feats).float())
        logit_cls = self.fc_out_cls(feats)
        loss_lm = text_reconstruction_loss(self.text_decoder, cfg, text_ids, text_mask, valid, **kw)
        loss_text_len = masked_cross_entropy(self.fc_text_len_rec(feats),
                                             text_len.clamp(0, cfg.text_len_table - 1), valid)
        bg_rec = self.bg_decoder(x0)

        # unconditional reconstruction (networks_detr.py:352-359)
        feats_u = reconst_decode(x0_uncond, padding_mask, self.pos_token_uncond,
                                 self.dec_fc_in_uncond, self.dec_transformer_uncond, **kw)
        bbox_pred_uncond = torch.sigmoid(self.bbox_embed_uncond(feats_u).float())
        logit_cls_uncond = self.fc_out_cls_uncond(feats_u)
        return (logit_disc, logit_disc_uncond, bbox_pred, logit_cls, loss_lm, loss_text_len,
                bg_rec, bbox_pred_uncond, logit_cls_uncond)
