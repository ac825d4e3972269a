"""DETR transformer encoder/decoder, batch-first, post-norm.

Counterpart of ``Transformer`` in ``layoutdetr_tpu/models/
detr_transformer.py`` with ``with_token=False`` (reference
detr_transformer.py:73-322): the Generator's 6+6-layer image-memory
encoder and layout-query decoder. The image position embedding is added
to queries and keys, never to values; the decoder has no query position;
``decoder.norm`` closes the decoder. Parameter names are the reference's
(``encoder.layers.{i}.self_attn.in_proj_weight`` ...). The D-side
variants (``with_token``, ``TransformerWithTokenEncoder``) come with the
training slice. Dropout is left out: this slice is inference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from layoutdetr_tpu_torch.models.layers import Dense, LayerNorm, MultiHeadAttention, padding_bias


class _FFN(nn.Module):
    def __init__(self, d_model: int, dim_feedforward: int, dtype):
        super().__init__()
        self.linear1 = Dense(d_model, dim_feedforward, dtype=dtype)
        self.linear2 = Dense(dim_feedforward, d_model, dtype=dtype)


class TransformerEncoderLayer(_FFN):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dtype=torch.float32):
        super().__init__(d_model, dim_feedforward, dtype)
        self.self_attn = MultiHeadAttention(d_model, nhead, dtype=dtype)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)

    def forward(self, src, pos):
        qk = src + pos
        src = self.norm1(src + self.self_attn(qk, qk, src))
        return self.norm2(src + self.linear2(F.relu(self.linear1(src))))


class TransformerDecoderLayer(_FFN):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dtype=torch.float32):
        super().__init__(d_model, dim_feedforward, dtype)
        self.self_attn = MultiHeadAttention(d_model, nhead, dtype=dtype)
        self.multihead_attn = MultiHeadAttention(d_model, nhead, dtype=dtype)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)

    def forward(self, tgt, memory, pos, tgt_attn_bias):
        tgt = self.norm1(tgt + self.self_attn(tgt, tgt, tgt, attn_bias=tgt_attn_bias))
        tgt = self.norm2(tgt + self.multihead_attn(tgt, memory + pos, memory))
        return self.norm3(tgt + self.linear2(F.relu(self.linear1(tgt))))


class _Stack(nn.Module):
    def __init__(self, layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        if norm is not None:
            self.norm = norm


class Transformer(nn.Module):
    """Image-memory encoder + layout-query decoder (networks_detr.py:99-108:
    d_model 256, 8 heads, 6+6 layers, FFN 2048)."""

    def __init__(self, d_model: int = 256, nhead: int = 8, num_encoder_layers: int = 6,
                 num_decoder_layers: int = 6, dim_feedforward: int = 2048,
                 dtype=torch.float32):
        super().__init__()
        self.encoder = _Stack(TransformerEncoderLayer(d_model, nhead, dim_feedforward, dtype)
                              for _ in range(num_encoder_layers))
        self.decoder = _Stack((TransformerDecoderLayer(d_model, nhead, dim_feedforward, dtype)
                               for _ in range(num_decoder_layers)), norm=LayerNorm(d_model))

    def forward(self, src, pos_embed, tgt, tgt_key_padding_mask):
        """src: [B,H,W,C] image features (unpadded, as the Generator gives
        them); pos_embed: [B,H,W,C]; tgt: [B,N,C] queries;
        tgt_key_padding_mask: [B,N] bool True=padded.

        Returns (hs [B,N,C], memory [B,H,W,C])."""
        b, h, w, c = src.shape
        src = src.reshape(b, h * w, c)
        pos = pos_embed.reshape(b, h * w, c).to(src.dtype)

        x = src
        for layer in self.encoder.layers:
            x = layer(x, pos)
        memory = x

        tgt_bias = padding_bias(tgt_key_padding_mask)
        y = tgt
        for layer in self.decoder.layers:
            y = layer(y, memory, pos, tgt_bias)
        return self.decoder.norm(y), memory.reshape(b, h, w, c)
