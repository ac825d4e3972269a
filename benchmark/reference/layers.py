"""Shared building blocks: Dense, MLP, LayerNorm, padding bias, dropout
and multi-head attention.

Counterpart of ``layoutdetr_tpu/models/layers.py``. Conventions kept:

- batch-first ``[B, S, D]``;
- parameters in fp32, matmuls in the module's ``dtype`` (weights are
  cast at use, as the JAX modules do);
- LayerNorm and softmax in fp32 whatever the activation dtype;
- masks are additive float biases;
- dropout follows JAX's ``deterministic`` flag; its masks come from an
  explicit ``torch.Generator`` on the tensor's device, never from the
  global RNG state;
- under tensor parallelism (``parallel.tensor_parallel``) a ``Dense``
  whose weight holds a slice of its outputs or inputs is column- or
  row-parallel, and a dropout of a sharded activation draws the whole
  mask and keeps its slice.

Parameter names and layouts are torch's own (``weight`` [out, in],
``in_proj_weight`` [3D, D], ``out_proj``), so a state dict of the port
uses the original networks_detr names.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn



class Dense(nn.Linear):
    """nn.Linear whose matmul runs in ``dtype`` (params stay fp32).
    A weight narrower than [out_features, in_features] makes it a
    tensor-parallel layer (``tensor_parallel.shard_module_``): fewer rows
    hold a rank's slice of the outputs (column-parallel), fewer columns
    a slice of the inputs (row-parallel). The shape marks the role, so a
    copy.deepcopy (G_ema) keeps it."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class MLP(nn.Module):
    """ReLU MLP head (networks_detr.py:50-62); params ``layers.{i}``."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(Dense(i, o, dtype=dtype) for i, o in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class LayerNorm(nn.LayerNorm):
    """fp32 LayerNorm over the trailing axis; output in the input's dtype."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: keep each entry with probability 1 - rate, scaled
    by 1 / (1 - rate), the mask drawn from ``generator``; the identity when
    ``deterministic`` or ``rate == 0``."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout with deterministic=False needs a torch.Generator")
    keep = torch.empty_like(x).bernoulli_(1.0 - rate, generator=generator)
    return torch.where(keep.bool(), x / (1.0 - rate), 0.0)


def padding_bias(key_padding_mask: torch.Tensor) -> torch.Tensor:
    """[B, S] bool (True = padded) -> [B, 1, 1, S] fp32 bias, -inf on padding."""
    return torch.zeros(key_padding_mask.shape, device=key_padding_mask.device).masked_fill(
        key_padding_mask, -math.inf)[:, None, None, :]


class MultiHeadAttention(nn.Module):
    """Batch-first multi-head attention with torch's packed ``in_proj``.

    Matches nn.MultiheadAttention math: one ``in_proj_weight`` [3D, D]
    whose thirds project q, k and v, scaled dot product with an additive
    bias, softmax in fp32, then ``out_proj``. A row whose keys are all
    masked gives NaN probabilities; they are set to zero, as in JAX, and
    then dropped out at rate ``dropout`` when not deterministic.
    """

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        assert d_model % num_heads == 0
        self.num_heads = num_heads
        self.dropout = dropout
        self.compute_dtype = dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = Dense(d_model, d_model, dtype=dtype)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.xavier_uniform_(self.out_proj.weight)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, q, k=None, v=None, *, attn_bias=None, deterministic=True, generator=None):
        """q: [B, Q, D]; k, v: [B, K, D] (None = self-attention).
        attn_bias: additive float bias broadcastable to [B, H, Q, K]."""
        k = q if k is None else k
        v = k if v is None else v
        dt = self.compute_dtype
        w = self.in_proj_weight.to(dt)
        bias = self.in_proj_bias.to(dt)
        if k is q and v is q:
            qh, kh, vh = F.linear(q.to(dt), w, bias).chunk(3, dim=-1)
        else:
            (wq, wk, wv), (bq, bk, bv) = w.chunk(3), bias.chunk(3)
            qh = F.linear(q.to(dt), wq, bq)
            kh = F.linear(k.to(dt), wk, bk)
            vh = F.linear(v.to(dt), wv, bv)

        b, nq, d_model = qh.shape
        nk = kh.shape[1]
        hd = d_model // self.num_heads
        qh = qh.reshape(b, nq, self.num_heads, hd)
        kh = kh.reshape(b, nk, self.num_heads, hd)
        vh = vh.reshape(b, nk, self.num_heads, hd)

        scores = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(hd)
        scores = scores.float()
        if attn_bias is not None:
            scores = scores + attn_bias
        probs = torch.nan_to_num(torch.softmax(scores, dim=-1))
        probs = dropout(probs, self.dropout, deterministic, generator).to(dt)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, vh).reshape(b, nq, d_model)
        return self.out_proj(out)
