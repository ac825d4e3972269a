"""BERT text encoder (the MED encoder in mode='text').

Counterpart of the encoder half of ``layoutdetr_tpu/models/bert.py``
(reference med.py:55-386, 574-812) at inference:

- embeddings = word + absolute position, LayerNorm eps 1e-12, no token
  type;
- additive key mask with the HF constant -10000;
- exact (erf) GELU; post-norm residual blocks;
- mode='text' only, so this slice's encoder carries no cross-attention
  parameters (the text decoder that needs them comes with training).

Parameter names are HF's (``embeddings.LayerNorm``,
``encoder.layer.{i}.attention.self.query`` ...). Dropout is left out:
the port runs the frozen encoder only in inference.

``BertSelfAttention`` sends self-attention with a key-only mask through
the fused kernel (``ops/attention.py``) when ``flash_attention`` is set
and no gradient is recorded, the condition under which the JAX module
dispatches to its Pallas kernel; otherwise it computes the same function
with plain tensor ops.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from layoutdetr_tpu_torch.config import BertConfig
from layoutdetr_tpu_torch.models.layers import Dense, LayerNorm
from layoutdetr_tpu_torch.ops.attention import fused_attention

NEG_MASK = -10000.0


def _bert_dense(cin: int, cout: int, dtype) -> Dense:
    layer = Dense(cin, cout, dtype=dtype)
    nn.init.normal_(layer.weight, std=0.02)
    nn.init.zeros_(layer.bias)
    return layer


def extended_attention_bias(attention_mask: torch.Tensor) -> torch.Tensor:
    """[B, T] 1 = attend -> additive fp32 [B, 1, 1, T] bias."""
    return (1.0 - attention_mask.float()[:, None, None, :]) * NEG_MASK


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, dtype=torch.float32):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.flash_attention = cfg.flash_attention
        self.query = _bert_dense(d, d, dtype)
        self.key = _bert_dense(d, d, dtype)
        self.value = _bert_dense(d, d, dtype)

    def forward(self, hidden, attn_bias):
        b, t, d = hidden.shape
        h = self.num_heads
        hd = d // h
        q = self.query(hidden).view(b, t, h, hd)
        k = self.key(hidden).view(b, t, h, hd)
        v = self.value(hidden).view(b, t, h, hd)

        key_only_bias = attn_bias.dim() == 4 and attn_bias.shape[1] == 1 and attn_bias.shape[2] == 1
        if self.flash_attention and key_only_bias and not torch.is_grad_enabled():
            out = fused_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                  attn_bias[:, 0, 0, :].float().contiguous(),
                                  scale=1.0 / math.sqrt(hd))
            return out.transpose(1, 2).reshape(b, t, d)

        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        probs = torch.softmax(scores.float() + attn_bias, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v).reshape(b, t, d)


class BertSelfOutput(nn.Module):
    """dense + residual LayerNorm."""

    def __init__(self, cfg: BertConfig, cin: int, dtype=torch.float32):
        super().__init__()
        self.dense = _bert_dense(cin, cfg.hidden_size, dtype)
        self.LayerNorm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x, residual):
        return self.LayerNorm(residual + self.dense(x))


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig, dtype=torch.float32):
        super().__init__()
        self.self = BertSelfAttention(cfg, dtype)
        self.output = BertSelfOutput(cfg, cfg.hidden_size, dtype)

    def forward(self, hidden, attn_bias):
        return self.output(self.self(hidden, attn_bias), hidden)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertConfig, dtype=torch.float32):
        super().__init__()
        self.dense = _bert_dense(cfg.hidden_size, cfg.intermediate_size, dtype)

    def forward(self, x):
        return F.gelu(self.dense(x))


class BertLayer(nn.Module):
    """Self-attention -> FFN, each with a residual LayerNorm."""

    def __init__(self, cfg: BertConfig, dtype=torch.float32):
        super().__init__()
        self.attention = BertAttention(cfg, dtype)
        self.intermediate = BertIntermediate(cfg, dtype)
        self.output = BertSelfOutput(cfg, cfg.intermediate_size, dtype)

    def forward(self, hidden, attn_bias):
        hidden = self.attention(hidden, attn_bias)
        return self.output(self.intermediate(hidden), hidden)


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig, dtype=torch.float32):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg, dtype) for _ in range(cfg.num_hidden_layers))

    def forward(self, x, attn_bias):
        for layer in self.layer:
            x = layer(x, attn_bias)
        return x


class BertEmbeddings(nn.Module):
    """word + position embeddings + LayerNorm (fp32), cast to ``dtype``."""

    def __init__(self, cfg: BertConfig, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.LayerNorm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        nn.init.normal_(self.word_embeddings.weight, std=0.02)
        nn.init.normal_(self.position_embeddings.weight, std=0.02)

    def forward(self, input_ids):
        seq = input_ids.shape[-1]
        x = self.word_embeddings(input_ids) + self.position_embeddings.weight[None, :seq]
        return self.LayerNorm(x).to(self.dtype)


class BertModel(nn.Module):
    """Encoder stack in mode='text': [B, T] ids and mask -> [B, T, D]."""

    def __init__(self, cfg: BertConfig, dtype=torch.float32):
        super().__init__()
        self.embeddings = BertEmbeddings(cfg, dtype)
        self.encoder = BertEncoder(cfg, dtype)

    def forward(self, input_ids, attention_mask):
        x = self.embeddings(input_ids)
        return self.encoder(x, extended_attention_bias(attention_mask))


class TextEncoder(BertModel):
    """Per-element CLS features, batched over B*N sequences at once
    (networks_detr.py:145-147): ids, mask [B, N, T] -> [B, N, D]."""

    def forward(self, text_ids, text_mask):
        b, n, t = text_ids.shape
        hidden = super().forward(text_ids.reshape(b * n, t), text_mask.reshape(b * n, t))
        return hidden[:, 0, :].reshape(b, n, -1)
