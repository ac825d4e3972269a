"""DETR transformer encoder/decoder and torch-style encoder stacks,
batch-first, post-norm.

Counterpart of ``layoutdetr_tpu/models/detr_transformer.py`` (reference
detr_transformer.py:22-322 and training/util.py:13-43):

- ``Transformer``: the Generator's 6+6-layer image-memory encoder and
  layout-query decoder; with ``with_token`` (the Discriminator's
  conditional critic) a learned CLS ``token`` is prepended to the
  queries. The image position embedding is added to queries and keys,
  never to values; the decoder has no query position; ``decoder.norm``
  closes the decoder.
- ``TorchEncoderLayer``: torch ``nn.TransformerEncoderLayer`` semantics,
  the layer of D's reconstruction decoders and unconditional critic.
- ``TransformerWithTokenEncoder``: a learned CLS ``token`` + N
  ``TorchEncoderLayer`` (``core.layers.{i}``), D's unconditional critic.

Dropout (rate ``dropout``, 0.1) on the attention probabilities, after
each attention and FFN block and inside the FFN, unless
``deterministic``. Parameter names are the reference's
(``encoder.layers.{i}.self_attn.in_proj_weight`` ...).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from layoutdetr_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    MultiHeadAttention,
    dropout,
    padding_bias,
)


class _FFN(nn.Module):
    def __init__(self, d_model: int, dim_feedforward: int, rate: float, dtype):
        super().__init__()
        self.rate = rate
        self.linear1 = Dense(d_model, dim_feedforward, dtype=dtype)
        self.linear2 = Dense(dim_feedforward, d_model, dtype=dtype)

    def ffn(self, x, deterministic, generator):
        h = dropout(F.relu(self.linear1(x)), self.rate, deterministic, generator)
        return dropout(self.linear2(h), self.rate, deterministic, generator)


class TransformerEncoderLayer(_FFN):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, dtype=torch.float32):
        super().__init__(d_model, dim_feedforward, dropout, dtype)
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout, dtype=dtype)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)

    def forward(self, src, pos, attn_bias=None, deterministic=True, generator=None):
        qk = src + pos
        sa = self.self_attn(qk, qk, src, attn_bias=attn_bias, deterministic=deterministic,
                            generator=generator)
        src = self.norm1(src + dropout(sa, self.rate, deterministic, generator))
        return self.norm2(src + self.ffn(src, deterministic, generator))


class TransformerDecoderLayer(_FFN):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, dtype=torch.float32):
        super().__init__(d_model, dim_feedforward, dropout, dtype)
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout, dtype=dtype)
        self.multihead_attn = MultiHeadAttention(d_model, nhead, dropout, dtype=dtype)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)

    def forward(self, tgt, memory, pos, tgt_attn_bias, memory_attn_bias=None,
                deterministic=True, generator=None):
        kw = dict(deterministic=deterministic, generator=generator)
        sa = self.self_attn(tgt, tgt, tgt, attn_bias=tgt_attn_bias, **kw)
        tgt = self.norm1(tgt + dropout(sa, self.rate, deterministic, generator))
        ca = self.multihead_attn(tgt, memory + pos, memory, attn_bias=memory_attn_bias, **kw)
        tgt = self.norm2(tgt + dropout(ca, self.rate, deterministic, generator))
        return self.norm3(tgt + self.ffn(tgt, deterministic, generator))


class _Stack(nn.Module):
    def __init__(self, layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        if norm is not None:
            self.norm = norm


class Transformer(nn.Module):
    """Image-memory encoder + layout-query decoder (networks_detr.py:99-108:
    d_model 256, 8 heads, 6+6 layers, FFN 2048); ``with_token`` prepends a
    learned CLS token to the queries (TransformerWithToken,
    detr_transformer.py:22-70)."""

    def __init__(self, d_model: int = 256, nhead: int = 8, num_encoder_layers: int = 6,
                 num_decoder_layers: int = 6, dim_feedforward: int = 2048, dropout: float = 0.1,
                 with_token: bool = False, dtype=torch.float32):
        super().__init__()
        self.encoder = _Stack(TransformerEncoderLayer(d_model, nhead, dim_feedforward, dropout, dtype)
                              for _ in range(num_encoder_layers))
        self.decoder = _Stack((TransformerDecoderLayer(d_model, nhead, dim_feedforward, dropout, dtype)
                               for _ in range(num_decoder_layers)), norm=LayerNorm(d_model))
        self.with_token = with_token
        if with_token:
            self.token = nn.Parameter(torch.randn(1, 1, d_model))

    def forward(self, src, pos_embed, tgt, tgt_key_padding_mask, deterministic=True,
                generator=None):
        """src: [B,H,W,C] image features (unpadded, as the models give
        them); pos_embed: [B,H,W,C]; tgt: [B,N,C] queries;
        tgt_key_padding_mask: [B,N] bool True=padded.

        Returns (hs [B, N (+1 with the token), C], memory [B,H,W,C])."""
        b, h, w, c = src.shape
        src = src.reshape(b, h * w, c)
        pos = pos_embed.reshape(b, h * w, c).to(src.dtype)
        kw = dict(deterministic=deterministic, generator=generator)

        x = src
        for layer in self.encoder.layers:
            x = layer(x, pos, **kw)
        memory = x

        if self.with_token:
            tgt = torch.cat([self.token.expand(b, 1, c).to(tgt.dtype), tgt], dim=1)
            tok_pad = torch.zeros(b, 1, dtype=torch.bool, device=tgt.device)
            tgt_key_padding_mask = torch.cat([tok_pad, tgt_key_padding_mask], dim=1)
        tgt_bias = padding_bias(tgt_key_padding_mask)
        y = tgt
        for layer in self.decoder.layers:
            y = layer(y, memory, pos, tgt_bias, **kw)
        return self.decoder.norm(y), memory.reshape(b, h, w, c)


class TorchEncoderLayer(_FFN):
    """torch nn.TransformerEncoderLayer semantics: post-norm, relu FFN."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, dropout: float = 0.1,
                 dtype=torch.float32):
        super().__init__(d_model, dim_feedforward, dropout, dtype)
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout, dtype=dtype)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)

    def forward(self, x, attn_bias=None, deterministic=True, generator=None):
        sa = self.self_attn(x, x, x, attn_bias=attn_bias, deterministic=deterministic,
                            generator=generator)
        x = self.norm1(x + dropout(sa, self.rate, deterministic, generator))
        return self.norm2(x + self.ffn(x, deterministic, generator))


class TransformerWithTokenEncoder(nn.Module):
    """Learned CLS ``token`` + N torch encoder layers (``core.layers.{i}``)
    (training/util.py:13-43). x [B, N, D], padding_mask [B, N] True=padded
    -> [B, N+1, D]; index 0 is the token."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, num_layers: int,
                 dropout: float = 0.1, dtype=torch.float32):
        super().__init__()
        self.token = nn.Parameter(torch.randn(1, 1, d_model))
        self.core = _Stack(TorchEncoderLayer(d_model, nhead, dim_feedforward, dropout, dtype)
                           for _ in range(num_layers))

    def forward(self, x, padding_mask, deterministic=True, generator=None):
        b, _, d = x.shape
        x = torch.cat([self.token.expand(b, 1, d).to(x.dtype), x], dim=1)
        pad = torch.cat([torch.zeros(b, 1, dtype=torch.bool, device=x.device), padding_mask], dim=1)
        bias = padding_bias(pad)
        for layer in self.core.layers:
            x = layer(x, bias, deterministic, generator)
        return x
