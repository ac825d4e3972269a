"""ResNet-50 backbone with frozen BatchNorm.

Counterpart of ``layoutdetr_tpu/models/resnet.py`` (reference
detr_backbone.py:29-114). The JAX module is NHWC with HWIO kernels; this
one is torch's NCHW with OIHW kernels and torchvision's parameter names
(``conv1``, ``bn1``, ``layer{s}.{b}.conv1`` ... ``downsample.0/1``), so
the state dict reads like the reference's. FrozenBatchNorm keeps its
four statistics as buffers and folds them to ``scale = w * rsqrt(var +
1e-5)``, ``shift = b - mean * scale``. Convolutions run in ``dtype``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class FrozenBatchNorm2d(nn.Module):
    """y = (x - mean) * weight / sqrt(var + eps) + bias, all constants."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


class Conv2d(nn.Conv2d):
    """Bias-free 'same' conv whose arithmetic runs in ``dtype``."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, kernel, stride=stride, padding=kernel // 2, bias=False)
        self.compute_dtype = dtype
        nn.init.kaiming_normal_(self.weight, mode="fan_out", nonlinearity="relu")

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride, self.padding)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1, expansion 4 (torchvision Bottleneck)."""

    def __init__(self, cin: int, width: int, stride: int = 1, downsample: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(cin, width, 1, dtype=dtype)
        self.bn1 = FrozenBatchNorm2d(width)
        self.conv2 = Conv2d(width, width, 3, stride=stride, dtype=dtype)
        self.bn2 = FrozenBatchNorm2d(width)
        self.conv3 = Conv2d(width, width * 4, 1, dtype=dtype)
        self.bn3 = FrozenBatchNorm2d(width * 4)
        self.downsample = (nn.Sequential(Conv2d(cin, width * 4, 1, stride=stride, dtype=dtype),
                                         FrozenBatchNorm2d(width * 4))
                           if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet50(nn.Module):
    """torchvision-resnet50-shaped body: NCHW image -> layer4 [B, 2048, H/32, W/32]."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, dtype=dtype)
        self.bn1 = FrozenBatchNorm2d(64)
        cin = 64
        for stage, (blocks, width) in enumerate(zip(stage_sizes, (64, 128, 256, 512)), start=1):
            layer = []
            for block in range(blocks):
                stride = 2 if (block == 0 and stage > 1) else 1
                layer.append(Bottleneck(cin, width, stride, downsample=(block == 0), dtype=dtype))
                cin = width * 4
            self.add_module(f"layer{stage}", nn.Sequential(*layer))

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))
