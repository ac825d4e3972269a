"""Adam with lazy-regularization scaling, and the frozen parameter set.

Counterpart of ``layoutdetr_tpu/training/optimizers.py``:

- Adam betas (0, 0.99), eps 1e-8, lr 1e-5 for both G and D
  (train.py:161-162, 204-205), ``torch.optim.Adam`` (the same update as
  optax.adam: bias-corrected moments, eps outside the square root);
- lazy-regularization scaling of lr and betas by mb_ratio = I / (I + 1)
  when a reg interval is set (training_loop.py:190-197), applied even
  when the regularizer's weight is 0, as the reference does (G 4, D 16);
- the frozen set: the BERT text encoder (training_loop.py:282-283) and
  the backbone's conv1/bn1/layer1 (detr_backbone.py:72-74), the JAX
  substrings mapped to the port's names. Frozen parameters get
  ``requires_grad=False`` and stay out of the optimizer (JAX masks their
  updates to zero, which leaves them where they are too).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

FROZEN_PREFIXES: Tuple[str, ...] = (
    "text_encoder.",
    "backbone.0.body.conv1.", "backbone.0.body.bn1.", "backbone.0.body.layer1.",
)


def freeze(module: nn.Module, frozen_prefixes: Sequence[str] = FROZEN_PREFIXES) -> list:
    """Set ``requires_grad=False`` on parameters under ``frozen_prefixes``;
    return the trainable ones."""
    trainable = []
    for name, p in module.named_parameters():
        frozen = name.startswith(tuple(frozen_prefixes))
        p.requires_grad_(not frozen)
        if not frozen:
            trainable.append(p)
    return trainable


def build_optimizer(module: nn.Module, lr: float = 1e-5, betas: Tuple[float, float] = (0.0, 0.99),
                    eps: float = 1e-8, reg_interval: Optional[int] = None,
                    frozen_prefixes: Sequence[str] = FROZEN_PREFIXES) -> torch.optim.Adam:
    """Freeze ``module``'s frozen set and return Adam over the rest."""
    if reg_interval is not None:
        mb_ratio = reg_interval / (reg_interval + 1)
        lr = lr * mb_ratio
        betas = tuple(b ** mb_ratio for b in betas)
    return torch.optim.Adam(freeze(module, frozen_prefixes), lr=lr, betas=betas, eps=eps)
