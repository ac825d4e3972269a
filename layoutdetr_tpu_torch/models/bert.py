"""BERT text encoder and causal-LM text decoder (the MED BERT).

Counterpart of ``layoutdetr_tpu/models/bert.py`` (reference
med.py:55-957):

- embeddings = word + absolute position, LayerNorm eps 1e-12, no token
  type;
- additive masks with the HF constant -10000, causal for the decoder;
- exact (erf) GELU; post-norm residual blocks;
- dropout on the embeddings, the attention probabilities, the attention
  output and the FFN output (``hidden_dropout_prob``,
  ``attention_probs_dropout_prob``) unless ``deterministic``, drawn from
  the ``generator`` passed down;
- every layer holds cross-attention parameters when
  ``add_cross_attention`` (keys and values ``encoder_width`` wide), as the
  reference's state dict does; mode='text', the only mode the models use,
  never runs them (the reference's text "reconstruction" is an
  unconditional LM, med.py:361);
- LM loss: shift by one, cross-entropy with label smoothing 0.1 and
  ignore index -100, a masked mean over static shapes.

Parameter names are HF's (``embeddings.LayerNorm``,
``encoder.layer.{i}.attention.self.query``, ``cls.predictions.decoder``).

``BertSelfAttention`` sends self-attention with a key-only mask through
the fused kernel (``ops/attention.py``) when ``flash_attention`` is set
and no gradient is recorded, the condition under which the JAX module
dispatches to its Pallas kernel; otherwise it computes the same function
with plain tensor ops. The decoder's causal [B, 1, T, T] bias keeps it on
the plain path. With dropout, the kernel takes one seed per layer
(``attn_seeds``), drawn on the host by the caller.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from layoutdetr_tpu_torch.config import BertConfig
from layoutdetr_tpu_torch.models.layers import Dense, LayerNorm, dropout
from layoutdetr_tpu_torch.ops.attention import fused_attention

NEG_MASK = -10000.0
IGNORE_INDEX = -100


def _bert_dense(cin: int, cout: int, dtype) -> Dense:
    layer = Dense(cin, cout, dtype=dtype)
    nn.init.normal_(layer.weight, std=0.02)
    nn.init.zeros_(layer.bias)
    return layer


def extended_attention_bias(attention_mask: torch.Tensor, is_decoder: bool = False) -> torch.Tensor:
    """[B, T] 1 = attend -> additive fp32 bias, [B, 1, 1, T] or, causal for
    the decoder, [B, 1, T, T] (med.py:612-671)."""
    am = attention_mask.float()
    if is_decoder:
        t = am.shape[-1]
        causal = torch.tril(torch.ones(t, t, device=am.device))
        return (1.0 - causal[None] * am[:, None, :])[:, None] * NEG_MASK
    return (1.0 - am[:, None, None, :]) * NEG_MASK


class BertSelfAttention(nn.Module):
    """Self- or cross-attention: separate q/k/v denses, k/v ``kv_width`` wide."""

    def __init__(self, cfg: BertConfig, kv_width: int, dtype=torch.float32):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.flash_attention = cfg.flash_attention
        self.probs_dropout = cfg.attention_probs_dropout_prob
        self.query = _bert_dense(d, d, dtype)
        self.key = _bert_dense(kv_width, d, dtype)
        self.value = _bert_dense(kv_width, d, dtype)

    def forward(self, hidden, attn_bias, deterministic=True, generator=None, seed=None):
        b, t, d = hidden.shape
        h = self.num_heads
        hd = d // h
        q = self.query(hidden).view(b, t, h, hd)
        k = self.key(hidden).view(b, t, h, hd)
        v = self.value(hidden).view(b, t, h, hd)

        key_only_bias = attn_bias.dim() == 4 and attn_bias.shape[1] == 1 and attn_bias.shape[2] == 1
        if self.flash_attention and key_only_bias and not torch.is_grad_enabled():
            rate = 0.0 if deterministic else self.probs_dropout
            out = fused_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                  attn_bias[:, 0, 0, :].float().contiguous(),
                                  scale=1.0 / math.sqrt(hd), dropout_rate=rate, seed=seed)
            return out.transpose(1, 2).reshape(b, t, d)

        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        probs = torch.softmax(scores.float() + attn_bias, dim=-1)
        probs = dropout(probs, self.probs_dropout, deterministic, generator)
        return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v).reshape(b, t, d)


class BertSelfOutput(nn.Module):
    """dense + dropout + residual LayerNorm."""

    def __init__(self, cfg: BertConfig, cin: int, dtype=torch.float32):
        super().__init__()
        self.dense = _bert_dense(cin, cfg.hidden_size, dtype)
        self.LayerNorm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.hidden_dropout = cfg.hidden_dropout_prob

    def forward(self, x, residual, deterministic=True, generator=None):
        x = dropout(self.dense(x), self.hidden_dropout, deterministic, generator)
        return self.LayerNorm(residual + x)


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig, kv_width: int, dtype=torch.float32):
        super().__init__()
        self.self = BertSelfAttention(cfg, kv_width, dtype)
        self.output = BertSelfOutput(cfg, cfg.hidden_size, dtype)

    def forward(self, hidden, attn_bias, deterministic=True, generator=None, seed=None):
        ctx = self.self(hidden, attn_bias, deterministic, generator, seed)
        return self.output(ctx, hidden, deterministic, generator)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertConfig, dtype=torch.float32):
        super().__init__()
        self.dense = _bert_dense(cfg.hidden_size, cfg.intermediate_size, dtype)

    def forward(self, x):
        return F.gelu(self.dense(x))


class BertLayer(nn.Module):
    """Self-attention -> FFN, each with a residual LayerNorm. The
    ``crossattention`` block (med.py:323-386) is held for the state dict;
    mode='text' skips it."""

    def __init__(self, cfg: BertConfig, dtype=torch.float32):
        super().__init__()
        self.attention = BertAttention(cfg, cfg.hidden_size, dtype)
        if cfg.add_cross_attention:
            self.crossattention = BertAttention(cfg, cfg.encoder_width, dtype)
        self.intermediate = BertIntermediate(cfg, dtype)
        self.output = BertSelfOutput(cfg, cfg.intermediate_size, dtype)

    def forward(self, hidden, attn_bias, deterministic=True, generator=None, seed=None):
        hidden = self.attention(hidden, attn_bias, deterministic, generator, seed)
        return self.output(self.intermediate(hidden), hidden, deterministic, generator)


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig, dtype=torch.float32):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg, dtype) for _ in range(cfg.num_hidden_layers))

    def forward(self, x, attn_bias, deterministic=True, generator=None,
                attn_seeds: Optional[Sequence[int]] = None):
        for i, layer in enumerate(self.layer):
            x = layer(x, attn_bias, deterministic, generator,
                      None if attn_seeds is None else attn_seeds[i])
        return x


class BertEmbeddings(nn.Module):
    """word + position embeddings + LayerNorm (fp32) + dropout, cast to ``dtype``."""

    def __init__(self, cfg: BertConfig, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.hidden_dropout = cfg.hidden_dropout_prob
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.LayerNorm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        nn.init.normal_(self.word_embeddings.weight, std=0.02)
        nn.init.normal_(self.position_embeddings.weight, std=0.02)

    def forward(self, input_ids, deterministic=True, generator=None):
        seq = input_ids.shape[-1]
        x = self.word_embeddings(input_ids) + self.position_embeddings.weight[None, :seq]
        x = dropout(self.LayerNorm(x), self.hidden_dropout, deterministic, generator)
        return x.to(self.dtype)


class BertModel(nn.Module):
    """Encoder stack in mode='text': [B, T] ids and mask -> [B, T, D]."""

    def __init__(self, cfg: BertConfig, dtype=torch.float32):
        super().__init__()
        self.embeddings = BertEmbeddings(cfg, dtype)
        self.encoder = BertEncoder(cfg, dtype)

    def forward(self, input_ids, attention_mask, *, is_decoder=False, deterministic=True,
                generator=None, attn_seeds=None):
        x = self.embeddings(input_ids, deterministic, generator)
        bias = extended_attention_bias(attention_mask, is_decoder)
        return self.encoder(x, bias, deterministic, generator, attn_seeds)


class TextEncoder(BertModel):
    """Per-element CLS features, batched over B*N sequences at once
    (networks_detr.py:145-147): ids, mask [B, N, T] -> [B, N, D]."""

    def forward(self, text_ids, text_mask, deterministic=True, generator=None, attn_seeds=None):
        b, n, t = text_ids.shape
        hidden = super().forward(text_ids.reshape(b * n, t), text_mask.reshape(b * n, t),
                                 deterministic=deterministic, generator=generator,
                                 attn_seeds=attn_seeds)
        return hidden[:, 0, :].reshape(b, n, -1)


class _MLMTransform(nn.Module):
    def __init__(self, cfg: BertConfig, dtype):
        super().__init__()
        self.dense = _bert_dense(cfg.hidden_size, cfg.hidden_size, dtype)
        self.LayerNorm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class _MLMPredictions(nn.Module):
    def __init__(self, cfg: BertConfig, dtype):
        super().__init__()
        self.transform = _MLMTransform(cfg, dtype)
        self.decoder = _bert_dense(cfg.hidden_size, cfg.vocab_size, dtype)


class BertLMHead(nn.Module):
    """MLM transform + vocab projection (HF BertOnlyMLMHead:
    ``predictions.transform.{dense, LayerNorm}``, ``predictions.decoder``)."""

    def __init__(self, cfg: BertConfig, dtype=torch.float32):
        super().__init__()
        self.predictions = _MLMPredictions(cfg, dtype)

    def forward(self, x):
        p = self.predictions
        x = p.transform.LayerNorm(F.gelu(p.transform.dense(x)))
        return p.decoder(x)


def lm_loss_label_smoothed(logits, labels, row_mask=None, label_smoothing: float = 0.1):
    """Shifted next-token CE with label smoothing and ignore_index=-100
    (med.py:912-918). ``row_mask`` [B] masks whole sequences; the mean is
    over non-ignored tokens of valid rows."""
    logits = logits[:, :-1].float()
    labels = labels[:, 1:]
    valid = labels != IGNORE_INDEX
    if row_mask is not None:
        valid = valid & row_mask[:, None]
    safe = torch.where(valid, labels, 0)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    smooth = -logp.mean(dim=-1)
    per_tok = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    m = valid.to(per_tok.dtype)
    return (per_tok * m).sum() / m.sum().clamp(min=1.0)


class BertLMHeadModel(nn.Module):
    """Causal decoder + LM head (med.py:814-957), mode='text'."""

    def __init__(self, cfg: BertConfig, dtype=torch.float32):
        super().__init__()
        self.bert = BertModel(cfg, dtype)
        self.cls = BertLMHead(cfg, dtype)

    def forward(self, input_ids, attention_mask, *, labels=None, row_mask=None,
                deterministic=True, generator=None):
        """Returns logits, or (logits, loss) with ``labels``."""
        hidden = self.bert(input_ids, attention_mask, is_decoder=True,
                           deterministic=deterministic, generator=generator)
        logits = self.cls(hidden)
        if labels is None:
            return logits
        return logits, lm_loss_label_smoothed(logits, labels, row_mask)
