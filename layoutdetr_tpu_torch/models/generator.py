"""LayoutDETR Generator.

Counterpart of ``layoutdetr_tpu/models/generator.py:132-330``
(reference networks_detr.py:65-187): background -> ResNet50 ->
``input_proj`` + sine position embedding; noise, labels, per-element
BERT CLS features and character-length embeddings -> ``fc_in``; then the
DETR transformer and ``bbox_embed`` + sigmoid. With ``reconst=True`` (the
training forward) the reconstruction heads follow: ``fc_z_rec`` (the
noise), ``fc_out_cls`` (labels), the causal text decoder
(``text_decoder``, a ``BertLMHeadModel`` in mode='text', i.e. an
unconditional LM as in the reference) and ``fc_text_len_rec``.

Text arrives tokenized as fixed-shape ``[B, N, T]`` ids and masks. The
frozen text encoder runs its self-attention through the fused kernel
(``flash_attention=True``, the default) when no gradient is recorded;
``flash_attention=False`` gives the same function with plain tensor ops.

Parameter names follow the reference state dict (``backbone.0.body.*``,
``input_proj``, ``fc_z``, ``emb_label``, ``text_encoder.*``,
``enc_text_len``, ``fc_in``, ``transformer.*``, ``bbox_embed``,
``fc_z_rec``, ``fc_out_cls``, ``text_decoder.*``, ``fc_text_len_rec``).
Dropout follows ``deterministic`` and is drawn from ``generator``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from layoutdetr_tpu_torch.config import GeneratorConfig
from layoutdetr_tpu_torch.metrics.layout_metrics import masked_cross_entropy, masked_mse
from layoutdetr_tpu_torch.models.bert import BertLMHeadModel, TextEncoder
from layoutdetr_tpu_torch.models.detr_transformer import Transformer
from layoutdetr_tpu_torch.models.layers import MLP, Dense
from layoutdetr_tpu_torch.models.position_encoding import position_embedding_sine
from layoutdetr_tpu_torch.models.resnet import ResNet50
from layoutdetr_tpu_torch.models.stylegan2 import normalize_2nd_moment


class _BackboneBody(nn.Module):
    """Holds the ResNet as ``body`` so that names read ``backbone.0.body.*``
    as in the reference's DETR Joiner."""

    def __init__(self, stage_sizes, dtype):
        super().__init__()
        self.body = ResNet50(stage_sizes, dtype=dtype)


def make_text_feature_fn(text_encoder: TextEncoder):
    """The frozen text encoder as a standalone CLS-feature extractor:
    ``fn(text_ids, text_mask, deterministic=True, generator=None)`` ->
    [B, N, bert_f_dim], computed without recording gradients (so its
    self-attention takes the fused kernel). Feed the result to
    ``Generator(..., text_feat=...)``. One device, plain batch.

    With ``deterministic=False`` the pass drops out as in training:
    ``generator`` is a CPU ``torch.Generator`` from which the host draws
    one attention seed per encoder layer and the seed of a device
    generator for the hidden dropouts, so no device sync is needed."""

    def fn(text_ids, text_mask, deterministic=True, generator=None):
        dev_gen = seeds = None
        if not deterministic:
            draws = torch.randint(0, 2 ** 31 - 1, (len(text_encoder.encoder.layer) + 1,),
                                  generator=generator).tolist()
            seeds = draws[1:]
            dev_gen = torch.Generator(device=text_ids.device).manual_seed(draws[0])
        with torch.no_grad():
            return text_encoder(text_ids, text_mask, deterministic, dev_gen, seeds)

    return fn


class Generator(nn.Module):
    """z + labels + texts + background -> bboxes [B, N, 4] (xc, yc, w, h)."""

    def __init__(self, cfg: GeneratorConfig, dtype: torch.dtype = torch.float32,
                 flash_attention: bool = True):
        super().__init__()
        if cfg.backbone != "resnet50":
            raise NotImplementedError(f"backbone {cfg.backbone!r} is not ported yet")
        self.cfg = cfg
        self.dtype = dtype
        self.backbone = nn.ModuleList([_BackboneBody(cfg.backbone_stage_sizes, dtype)])
        self.input_proj = nn.Conv2d(2048, cfg.hidden_dim, kernel_size=1)
        self.fc_z = Dense(cfg.max_elements * cfg.z_dim, cfg.bert_f_dim, dtype=dtype)
        self.emb_label = nn.Embedding(cfg.num_bbox_labels, cfg.bert_f_dim)
        self.text_encoder = TextEncoder(cfg.encoder_bert_config(flash_attention), dtype=dtype)
        self.enc_text_len = nn.Embedding(cfg.text_len_table, cfg.bert_f_dim)
        self.fc_in = MLP(4 * cfg.bert_f_dim, cfg.bert_f_dim, cfg.hidden_dim, 3, dtype=dtype)
        self.transformer = Transformer(cfg.hidden_dim, cfg.nhead, cfg.num_encoder_layers,
                                       cfg.num_decoder_layers, cfg.dim_feedforward, dtype=dtype)
        self.bbox_embed = MLP(cfg.hidden_dim, cfg.hidden_dim, 4, 3, dtype=dtype)
        # reconstruction heads (networks_detr.py:110-131)
        self.fc_z_rec = Dense(cfg.hidden_dim, cfg.z_dim * cfg.max_elements, dtype=dtype)
        self.fc_out_cls = Dense(cfg.hidden_dim, cfg.num_bbox_labels, dtype=dtype)
        self.text_decoder = BertLMHeadModel(cfg.decoder_bert_config(), dtype=dtype)
        self.fc_text_len_rec = Dense(cfg.hidden_dim, cfg.text_len_table, dtype=dtype)

    def forward(self, z, bbox_class, bbox_real, text_ids, text_mask, text_len, padding_mask,
                background, reconst: bool = False, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                text_feat: Optional[torch.Tensor] = None):
        """z: [B, N, z_dim] noise; bbox_class: [B, N] int; bbox_real: unused
        (kept for the reference signature); text_ids/text_mask: [B, N, T];
        text_len: [B, N] int character lengths, clipped to
        text_len_table-1; padding_mask: [B, N] bool True = padded;
        background: [B, S, S, 3] ImageNet-normalized, channels last;
        reconst: also run the reconstruction heads; deterministic: no
        dropout, else drawn from ``generator`` (on the model's device);
        text_feat: optional precomputed [B, N, bert_f_dim] CLS features
        (the train step's hoisted frozen text pass).

        Returns bbox_fake [B, N, 4] fp32 in (0, 1), or with ``reconst``
        (bbox_fake, loss_z, logit_cls, loss_lm, loss_text_len)."""
        del bbox_real
        cfg, dt = self.cfg, self.dtype
        b, n = bbox_class.shape

        # background features, channels first inside, channels last out
        feat = self.backbone[0].body(background.permute(0, 3, 1, 2))
        proj = F.conv2d(feat.to(dt), self.input_proj.weight.to(dt), self.input_proj.bias.to(dt))
        feat = feat.permute(0, 2, 3, 1)
        pos = position_embedding_sine(feat, cfg.hidden_dim // 2)
        bg_proj = proj.permute(0, 2, 3, 1)

        # element queries
        z0 = normalize_2nd_moment(z.reshape(b, -1).float())
        zf = self.fc_z(z0)[:, None, :].expand(b, n, cfg.bert_f_dim)
        lf = self.emb_label(bbox_class).to(dt)
        if text_feat is None:
            text_feat = self.text_encoder(text_ids, text_mask, deterministic, generator)
        text_feat = text_feat.to(dt)
        tlf = self.enc_text_len(text_len.clamp(0, cfg.text_len_table - 1)).to(dt)
        x = F.relu(self.fc_in(torch.cat([zf, lf, text_feat, tlf], dim=-1)))

        hs, _ = self.transformer(bg_proj, pos, x, padding_mask, deterministic, generator)
        bbox_fake = torch.sigmoid(self.bbox_embed(hs).float())
        if not reconst:
            return bbox_fake

        valid = ~padding_mask
        z_rec = self.fc_z_rec(hs)
        loss_z = masked_mse(z_rec.float(), z0[:, None, :].expand(z_rec.shape), valid)
        logit_cls = self.fc_out_cls(hs)
        loss_lm = text_reconstruction_loss(self.text_decoder, cfg, text_ids, text_mask, valid,
                                           deterministic, generator)
        loss_text_len = masked_cross_entropy(self.fc_text_len_rec(hs),
                                             text_len.clamp(0, cfg.text_len_table - 1), valid)
        return bbox_fake, loss_z, logit_cls, loss_lm, loss_text_len


def text_reconstruction_loss(text_decoder: BertLMHeadModel, cfg: GeneratorConfig, text_ids,
                             text_mask, valid, deterministic=True, generator=None):
    """The text decoder's LM loss over every valid element's string
    (networks_detr.py:176-183): the first token becomes [DEC] (bos), pad
    tokens are ignored, padded elements are masked out."""
    b, n, t = text_ids.shape
    dec_ids = text_ids.clone()
    dec_ids[:, :, 0] = cfg.bos_token_id
    dec_ids = dec_ids.reshape(b * n, t)
    targets = torch.where(dec_ids == cfg.pad_token_id, -100, dec_ids)
    _, loss = text_decoder(dec_ids, text_mask.reshape(b * n, t), labels=targets,
                           row_mask=valid.reshape(b * n), deterministic=deterministic,
                           generator=generator)
    return loss
