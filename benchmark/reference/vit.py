"""Vision Transformer image backbone (``--backbone vit``).

Counterpart of ``layoutdetr_tpu/models/vit.py`` (reference
training/networks_vit.py:27-308): ``PatchEmbed``, the pre-norm
``ViTBlock``, ``VisionTransformer`` (patch 16, width 768, depth 12, 12
heads) and ``VisionTransformerDecoder``, which nothing calls, as in JAX.

The dtype flow is the JAX module's: LayerNorms in fp32 (eps 1e-5, output
in the input's dtype), every Dense in the run's dtype, the logits q.k in
q's dtype and then divided by sqrt(head dim) in that dtype, the softmax
in fp32 with p cast to v's dtype, exact GELU. Attention is plain tensor
ops: JAX computes it outside any Pallas kernel, the port's fused kernel
is built for head dim 192 only (ViT's is 64), and R1 differentiates D
twice. fp32 matmuls go to cuBLAS, which keeps TF32 off unless a caller
turns it on; that is why the patch embedding, one stride-16 conv in JAX,
runs here as the same sum written as one GEMM over the unfolded patches
(cuDNN would use TF32 for an fp32 conv by default).

The reference ships no torch ViT state dict to take names from, so the
names are the JAX tree's, dotted: ``patch_embed.{weight,bias}`` (weight
OIHW [768, 3, 16, 16]), ``pos_embed`` [1, (S/16)^2, 768],
``blocks.{i}.{norm1,qkv,proj,norm2,fc1,fc2}`` and ``norm``; under G and D
they sit below ``backbone.``. Inputs are NCHW and ``VisionTransformer``
returns an NCHW map [B, 768, S/16, S/16], as the port's ResNet does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, LayerNorm


class PatchEmbed(nn.Module):
    """Non-overlapping ``patch_size`` patches -> ``embed_dim`` features
    (networks_vit.py:27-46); a VALID conv of stride ``patch_size``, so rows
    and columns past the last whole patch are dropped. x: [B, C, H, W] ->
    [B, H/ps, W/ps, embed_dim] in ``dtype``."""

    def __init__(self, patch_size: int = 16, in_chans: int = 3, embed_dim: int = 768,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.empty(embed_dim, in_chans, patch_size, patch_size))
        self.bias = nn.Parameter(torch.zeros(embed_dim))
        nn.init.xavier_uniform_(self.weight)

    def forward(self, x):
        b, c, h, w = x.shape
        ps, dt = self.patch_size, self.compute_dtype
        gh, gw = h // ps, w // ps
        patches = (x[:, :, :gh * ps, :gw * ps].reshape(b, c, gh, ps, gw, ps)
                   .permute(0, 2, 4, 1, 3, 5).reshape(b, gh, gw, c * ps * ps))
        y = F.linear(patches.to(dt), self.weight.reshape(self.weight.shape[0], -1).to(dt))
        return y + self.bias.to(dt)


class ViTBlock(nn.Module):
    """Pre-norm multi-head self-attention + GELU MLP (networks_vit.py:115-137).
    x: [B, S, dim] in ``dtype``."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.qkv = Dense(dim, 3 * dim, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.fc1 = Dense(dim, int(dim * mlp_ratio), dtype=dtype)
        self.fc2 = Dense(int(dim * mlp_ratio), dim, dtype=dtype)

    def forward(self, x):
        b, s, d = x.shape
        hd = d // self.num_heads
        # [B, S, 3, H, hd] -> three [B, H, S, hd]
        q, k, v = self.qkv(self.norm1(x)).reshape(b, s, 3, self.num_heads, hd).permute(2, 0, 3, 1, 4)
        scale = torch.tensor(math.sqrt(hd), dtype=torch.float32).to(q.dtype)
        attn = torch.matmul(q, k.transpose(-1, -2)) / scale
        attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, s, d)
        x = x + self.proj(out)
        h = F.gelu(self.fc1(self.norm2(x)))
        return x + self.fc2(h)


class VisionTransformer(nn.Module):
    """ViT over an ``img_size``^2 image: [B, 3, S, S] -> NCHW map
    [B, embed_dim, S/ps, S/ps] in ``dtype``. ``img_size`` fixes the length
    of ``pos_embed`` (JAX infers it from the first input)."""

    def __init__(self, img_size: int, patch_size: int = 16, in_chans: int = 3,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dim = embed_dim
        grid = img_size // patch_size
        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim, dtype)
        self.pos_embed = nn.Parameter(torch.randn(1, grid * grid, embed_dim) * 0.02)
        self.blocks = nn.ModuleList(ViTBlock(embed_dim, num_heads, mlp_ratio, dtype)
                                    for _ in range(depth))
        self.norm = LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x):
        feat = self.patch_embed(x)
        b, gh, gw, d = feat.shape
        tokens = feat.reshape(b, gh * gw, d)
        tokens = tokens + self.pos_embed.to(tokens.dtype)
        for block in self.blocks:
            tokens = block(tokens)
        return self.norm(tokens).reshape(b, gh, gw, d).permute(0, 3, 1, 2)


class VisionTransformerDecoder(nn.Module):
    """Tokens -> pixel patches (networks_vit.py:231-308), for masked-image
    objectives; no model calls it. Takes ``VisionTransformer``'s NCHW map
    [B, D, gh, gw] and returns the image channels last,
    [B, gh*ps, gw*ps, out_chans], as the JAX module does."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 768, depth: int = 4,
                 num_heads: int = 12, out_chans: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.out_chans = out_chans
        self.blocks = nn.ModuleList(ViTBlock(embed_dim, num_heads, dtype=dtype)
                                    for _ in range(depth))
        self.norm = LayerNorm(embed_dim, eps=1e-5)
        self.pred = Dense(embed_dim, patch_size * patch_size * out_chans, dtype=dtype)

    def forward(self, feat):
        b, d, gh, gw = feat.shape
        x = feat.permute(0, 2, 3, 1).reshape(b, gh * gw, d)
        for block in self.blocks:
            x = block(x)
        ps, c = self.patch_size, self.out_chans
        x = self.pred(self.norm(x)).reshape(b, gh, gw, ps, ps, c)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(b, gh * ps, gw * ps, c)
