"""Plain bias + activation + gain + clamp, differentiated by autograd.

``y = clamp(act(x + b[c]) * gain, -clamp, clamp)`` in fp32 (or wider),
stored in x's dtype, for the activations the StyleGAN2 layers use with
their default alpha and gain (StyleGAN2's bias_act.py:22-32).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

# name -> (default alpha, default gain)
activation_funcs = {
    "linear": (0.0, 1.0),
    "relu": (0.0, math.sqrt(2)),
    "lrelu": (0.2, math.sqrt(2)),
    "tanh": (0.0, 1.0),
    "sigmoid": (0.0, 1.0),
}


def _act(z, act: str, alpha: float):
    if act == "linear":
        return z
    if act == "relu":
        return torch.clamp(z, min=0.0)
    if act == "lrelu":
        return torch.where(z >= 0, z, z * alpha)
    if act == "tanh":
        return torch.tanh(z)
    if act == "sigmoid":
        return torch.sigmoid(z)
    raise ValueError(f"unknown activation {act!r}")


def bias_act(x, b=None, dim: int = 1, act: str = "linear", alpha=None, gain=None,
             clamp: Optional[float] = None):
    def_alpha, def_gain = activation_funcs[act]
    alpha = def_alpha if alpha is None else float(alpha)
    gain = def_gain if gain is None else float(gain)
    ct = torch.promote_types(x.dtype, torch.float32)
    z = x.to(ct)
    if b is not None:
        shape = [1] * x.dim()
        shape[dim % x.dim()] = -1
        z = z + b.to(ct).reshape(shape)
    y = _act(z, act, alpha) * gain
    if clamp is not None:
        y = y.clamp(-clamp, clamp)
    return y.to(x.dtype)
