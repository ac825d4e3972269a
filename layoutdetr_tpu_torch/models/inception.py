"""InceptionV3 feature extractor of the image FID (TF inception-2015-12-05).

Counterpart of ``layoutdetr_tpu/models/inception.py:34-250`` (the network
the reference featurizes composited banners with: 2048-d pool3 features,
metrics/frechet_inception_distance.py:22). The JAX module is NHWC with
HWIO kernels; this one is NCHW with OIHW kernels and pytorch-fid's
(torchvision's) state-dict names (``Conv2d_1a_3x3.conv.weight``,
``Mixed_7c.branch_pool.bn.running_var``, ...), so pytorch-fid's
``pt_inception-2015-12-05`` state dict loads as it is (its ``fc`` and
``num_batches_tracked`` entries, which the features never read, are
dropped).

The FID variant's differences from torchvision's InceptionV3: the avg
pools of InceptionA/C/E exclude the padding from the count; Mixed_7c pools
by max (stride 1, padding 1, padded with -inf); the features are the mean
over H and W in fp32. BatchNorm is frozen, eps 1e-3. Convolutions run on
cuDNN (or the CPU's kernels): the JAX package computes them with XLA
convolutions, not a Pallas kernel.
"""

from __future__ import annotations

import os
from typing import Callable, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from layoutdetr_tpu_torch.models.resnet import FrozenBatchNorm2d

FEATURE_DIM = 2048


class BasicConv2d(nn.Module):
    """Conv (no bias) + frozen BN (eps 1e-3) + ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = FrozenBatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_no_pad(x):
    """3x3 stride-1 avg pool that counts only the pixels inside (FID tweak)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, bd, self.branch_pool(_avg_pool_no_pad(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                     self.branch7x7dbl_5):
            bd = conv(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool_no_pad(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for conv in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, pool: str = "avg"):
        super().__init__()
        self.pool = pool  # Mixed_7c: "max" (FID tweak)
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        pooled = F.max_pool2d(x, 3, stride=1, padding=1) if self.pool == "max" else _avg_pool_no_pad(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(pooled)], 1)


class InceptionV3(nn.Module):
    """FID InceptionV3: preprocessed NCHW input in [-1, 1] -> [B, 2048] features."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")

    def forward(self, x):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a, self.Mixed_6b,
                      self.Mixed_6c, self.Mixed_6d, self.Mixed_6e, self.Mixed_7a, self.Mixed_7b,
                      self.Mixed_7c):
            x = block(x)
        return x.float().mean(dim=(2, 3))


def preprocess_uint8(imgs: torch.Tensor, size: int = 299) -> torch.Tensor:
    """uint8 NHWC [0, 255] -> NCHW float in [-1, 1] at size x size
    (pytorch-fid's resize_input/normalize_input). The resize is bilinear
    with antialiasing, as ``jax.image.resize`` does by default (without
    it, a 1024^2 -> 299^2 downsample differs by up to 0.57 on [0, 1])."""
    x = imgs.permute(0, 3, 1, 2).float() / 255.0
    if tuple(x.shape[2:]) != (size, size):
        x = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                          antialias=True)
    return x * 2.0 - 1.0


def make_feature_fn(model: InceptionV3) -> Callable[[np.ndarray], np.ndarray]:
    """uint8 NHWC images (numpy) -> [B, 2048] float32 numpy pool3 features,
    computed on the model's device."""
    device = next(model.parameters()).device

    def features(imgs: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(imgs)).to(device)
        with torch.inference_mode():
            return model(preprocess_uint8(x)).cpu().numpy()

    return features


def _unflatten(flat: dict) -> dict:
    """{'a/b/c': array} -> nested dicts."""
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def load_inception_params(src: Union[str, dict], device="cuda") -> InceptionV3:
    """An InceptionV3 in eval mode on ``device`` from ``src``: a torch
    ``.pth``/``.pt`` state dict in pytorch-fid naming (a ``{"state_dict":
    ...}`` wrapper is unwrapped), a JAX ``.npz`` of flattened 'a/b/c' keys,
    or an in-memory torch state dict or JAX param tree. ``fc.*``,
    ``AuxLogits.*`` and ``num_batches_tracked`` entries are dropped; the
    rest must match strictly."""
    from layoutdetr_tpu_torch.utils.convert import inception_state_dict_from_jax

    if isinstance(src, str):
        if os.path.isdir(src):
            raise ValueError(f"{src} is a directory (an orbax checkpoint?); the port reads a torch "
                             "state dict or an .npz: convert it on a JAX host with "
                             "`python tools/orbax_to_port.py --kind inception --src DIR --dest "
                             "FILE`")
        if src.endswith(".npz"):
            with np.load(src) as f:
                src = _unflatten(dict(f))
        else:
            src = torch.load(src, map_location="cpu", weights_only=True)
            if "state_dict" in src and isinstance(src["state_dict"], dict):
                src = src["state_dict"]
    if "Conv2d_1a_3x3" in src or set(src) == {"params"}:  # a JAX param tree
        sd = inception_state_dict_from_jax(src)
    else:
        sd = {k: torch.as_tensor(v) for k, v in src.items()
              if not (k.startswith(("fc.", "AuxLogits.")) or k.endswith("num_batches_tracked"))}
    model = InceptionV3()
    model.load_state_dict(sd, strict=True)
    return model.to(device).eval()
