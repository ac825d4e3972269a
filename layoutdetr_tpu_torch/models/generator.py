"""LayoutDETR Generator, layout inference path (``reconst=False``).

Counterpart of ``layoutdetr_tpu/models/generator.py:132-298``
(reference networks_detr.py:65-158): background -> ResNet50 ->
``input_proj`` + sine position embedding; noise, labels, per-element
BERT CLS features and character-length embeddings -> ``fc_in``; then the
DETR transformer and ``bbox_embed`` + sigmoid.

Text arrives tokenized as fixed-shape ``[B, N, T]`` ids and masks. The
frozen text encoder runs its self-attention through the fused kernel
(``flash_attention=True``, the default) when no gradient is recorded;
``flash_attention=False`` gives the same function with plain tensor ops.

Parameter names follow the reference state dict (``backbone.0.body.*``,
``input_proj``, ``fc_z``, ``emb_label``, ``text_encoder.*``,
``enc_text_len``, ``fc_in``, ``transformer.*``, ``bbox_embed``). The
reconstruction heads and the text decoder come with the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from layoutdetr_tpu_torch.config import GeneratorConfig
from layoutdetr_tpu_torch.models.bert import TextEncoder
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
    ``fn(text_ids, text_mask)`` -> [B, N, bert_f_dim], computed without
    recording gradients (so its self-attention takes the fused kernel).
    Feed the result to ``Generator(..., text_feat=...)``. One device,
    plain batch."""

    def fn(text_ids, text_mask):
        with torch.no_grad():
            return text_encoder(text_ids, text_mask)

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

    def forward(self, z, bbox_class, bbox_real, text_ids, text_mask, text_len, padding_mask,
                background, text_feat: Optional[torch.Tensor] = None):
        """z: [B, N, z_dim] noise; bbox_class: [B, N] int; bbox_real: unused
        (kept for the reference signature); text_ids/text_mask: [B, N, T];
        text_len: [B, N] int character lengths, clipped to
        text_len_table-1; padding_mask: [B, N] bool True = padded;
        background: [B, S, S, 3] ImageNet-normalized, channels last;
        text_feat: optional precomputed [B, N, bert_f_dim] CLS features.

        Returns bbox_fake [B, N, 4] fp32 in (0, 1)."""
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
            text_feat = self.text_encoder(text_ids, text_mask)
        text_feat = text_feat.to(dt)
        tlf = self.enc_text_len(text_len.clamp(0, cfg.text_len_table - 1)).to(dt)
        x = F.relu(self.fc_in(torch.cat([zf, lf, text_feat, tlf], dim=-1)))

        hs, _ = self.transformer(bg_proj, pos, x, padding_mask)
        return torch.sigmoid(self.bbox_embed(hs).float())
