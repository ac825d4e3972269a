"""StyleGAN2 pieces of the port.

Counterpart of ``layoutdetr_tpu/models/stylegan2.py``. The Generator's
layout path needs only ``normalize_2nd_moment``; the Discriminator's
``bg_decoder`` stack comes with the training slice.
"""

from __future__ import annotations

import torch


def normalize_2nd_moment(x: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    """x * rsqrt(mean(x^2)) (networks_stylegan2.py:23-25)."""
    return x * torch.reciprocal(torch.sqrt(x.square().mean(dim=dim, keepdim=True) + eps))
