"""2D sine/cosine position embedding for image feature maps.

Counterpart of ``layoutdetr_tpu/models/position_encoding.py``
(reference detr_position_encoding.py:22-58). Output is channels-last
``[B, H, W, 2*num_pos_feats]``: y-features, then x-features, each with
sin on even and cos on odd channels, interleaved.
"""

from __future__ import annotations

import math

import torch


def sine_position_embedding(mask: torch.Tensor, num_pos_feats: int = 128) -> torch.Tensor:
    """mask: [B, H, W] bool, True = padded. Returns fp32 [B, H, W, 2F],
    positions normalized to (0, 2*pi], temperature 10000."""
    not_mask = (~mask).float()
    y_embed = not_mask.cumsum(1)
    x_embed = not_mask.cumsum(2)
    eps = 1e-6
    y_embed = y_embed / (y_embed[:, -1:, :] + eps) * (2 * math.pi)
    x_embed = x_embed / (x_embed[:, :, -1:] + eps) * (2 * math.pi)

    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=mask.device)
    dim_t = 10000.0 ** (2 * torch.floor(dim_t / 2) / num_pos_feats)

    def interleave(pos):
        return torch.stack([pos[..., 0::2].sin(), pos[..., 1::2].cos()], dim=-1).flatten(-2)

    pos_x = interleave(x_embed[..., None] / dim_t)
    pos_y = interleave(y_embed[..., None] / dim_t)
    return torch.cat([pos_y, pos_x], dim=-1)


def position_embedding_sine(x: torch.Tensor, num_pos_feats: int = 128) -> torch.Tensor:
    """PositionEmbeddingSine of an unpadded map: x [B, H, W, C] -> embedding
    in x's dtype."""
    mask = torch.zeros(x.shape[:3], dtype=torch.bool, device=x.device)
    return sine_position_embedding(mask, num_pos_feats).to(x.dtype)
