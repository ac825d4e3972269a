"""StyleGAN2 pieces of the port: the Discriminator's background decoder.

Counterpart of ``layoutdetr_tpu/models/stylegan2.py`` for what
``Decoder`` reaches (reference networks_stylegan2.py:23-994):
``FullyConnectedLayer``, ``modulated_conv2d``, ``SynthesisLayer``,
``ToRGBLayer``, ``SynthesisBlock`` ('skip' architecture),
``SynthesisNetwork``, ``DecoderMappingNetwork`` and ``Decoder``, the
latter as D instantiates it (networks_detr.py:261: no noise, no conv
clamp). ``Conv2dLayer``, ``MappingNetwork`` and the encoder blocks are
not on the port's path yet.

Every bias + activation goes through ``ops.bias_act`` (a CUDA kernel on
the card, forward and backward). Inside, activations are NCHW and
weights torch's OIHW with the reference's names and shapes (``const``
[C, r, r], ``affine``, ``mapping.fc{i}``), so the state dict reads like
the reference's; ``Decoder`` returns the image channels last,
[B, S, S, 3], as the JAX module does. Modulation runs as scale inputs ->
one shared-weight conv -> demodulate outputs, the JAX package's form.
As in JAX, the ``affine`` layers compute in fp32 whatever ``dtype`` is.
The FIR filters are non-persistent buffers, so they live on the model's
device (a host filter would be copied, and the host stalled, at every
use) and stay out of the state dict.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from layoutdetr_tpu_torch.ops.bias_act import activation_funcs, bias_act
from layoutdetr_tpu_torch.ops.conv2d_resample import conv2d_resample
from layoutdetr_tpu_torch.ops.upfirdn2d import setup_filter, upsample2d

RESAMPLE_FILTER = (1, 3, 3, 1)


def normalize_2nd_moment(x: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    """x * rsqrt(mean(x^2)) (networks_stylegan2.py:23-25)."""
    return x * torch.reciprocal(torch.sqrt(x.square().mean(dim=dim, keepdim=True) + eps))


class FullyConnectedLayer(nn.Module):
    """Equalized-LR linear (networks_stylegan2.py:92-126): weight [out, in]
    ~ N(0, 1) / lr_multiplier, scaled at run time by lr_multiplier /
    sqrt(in); bias starts at ``bias_init`` and is scaled by lr_multiplier."""

    def __init__(self, in_features: int, out_features: int, activation: str = "linear",
                 lr_multiplier: float = 1.0, bias_init: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.activation = activation
        self.lr_multiplier = lr_multiplier
        self.weight_gain = lr_multiplier / math.sqrt(in_features)
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.randn(out_features, in_features) / lr_multiplier)
        self.bias = nn.Parameter(torch.full((out_features,), float(bias_init)))

    def forward(self, x):
        dt = self.compute_dtype
        y = F.linear(x.to(dt), (self.weight * self.weight_gain).to(dt))
        b = (self.bias * self.lr_multiplier).to(y.dtype)
        return bias_act(y, b, dim=1, act=self.activation)


def modulated_conv2d(x, weight, styles, up=1, padding=0, resample_filter=None,
                     demodulate=True, flip_weight=True):
    """Style-modulated conv (networks_stylegan2.py:30-87), input-scaling form.
    x: [N, Ci, H, W]; weight: [Co, Ci, kh, kw]; styles: [N, Ci]."""
    dcoefs = None
    if demodulate:
        w2 = weight.float().square().sum(dim=(2, 3))  # [Co, Ci]
        sigma = styles.float().square() @ w2.t()  # [N, Co]
        dcoefs = torch.reciprocal(torch.sqrt(sigma + 1e-8))
    x = x * styles.to(x.dtype)[:, :, None, None]
    x = conv2d_resample(x, weight.to(x.dtype), f=resample_filter, up=up, padding=padding,
                        flip_weight=flip_weight)
    if demodulate:
        x = x * dcoefs.to(x.dtype)[:, :, None, None]
    return x


class SynthesisLayer(nn.Module):
    """Modulated conv + bias + lrelu (networks_stylegan2.py:272-331), no noise."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int, resolution: int,
                 kernel_size: int = 3, up: int = 1, activation: str = "lrelu",
                 resample_filter: Sequence[int] = RESAMPLE_FILTER,
                 conv_clamp: Optional[float] = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.up = up
        self.padding = kernel_size // 2
        self.activation = activation
        self.conv_clamp = conv_clamp
        self.register_buffer("resample_filter", torch.tensor(setup_filter(resample_filter)),
                             persistent=False)
        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1.0)
        self.weight = nn.Parameter(torch.randn(out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x, w, gain: float = 1.0):
        styles = self.affine(w)
        x = modulated_conv2d(x, self.weight, styles, up=self.up, padding=self.padding,
                             resample_filter=self.resample_filter, flip_weight=(self.up == 1))
        act_gain = activation_funcs[self.activation].def_gain * gain
        act_clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return bias_act(x, self.bias.to(x.dtype), dim=1, act=self.activation, gain=act_gain,
                        clamp=act_clamp)


class ToRGBLayer(nn.Module):
    """1x1 modulated conv to image channels, no demodulation
    (networks_stylegan2.py:336-356)."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int, kernel_size: int = 1,
                 conv_clamp: Optional[float] = None):
        super().__init__()
        self.conv_clamp = conv_clamp
        self.weight_gain = 1.0 / math.sqrt(in_channels * kernel_size ** 2)
        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1.0)
        self.weight = nn.Parameter(torch.randn(out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x, w):
        styles = self.affine(w) * self.weight_gain
        x = modulated_conv2d(x, self.weight, styles, demodulate=False)
        return bias_act(x, self.bias.to(x.dtype), dim=1, clamp=self.conv_clamp)


class SynthesisBlock(nn.Module):
    """One resolution of the synthesis net, 'skip' architecture
    (networks_stylegan2.py:361-457). ``in_channels`` 0 = the first block,
    which starts from the learned ``const``."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int, resolution: int,
                 img_channels: int, conv_clamp: Optional[float] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_channels = in_channels
        self.dtype = dtype
        self.register_buffer("resample_filter", torch.tensor(setup_filter(RESAMPLE_FILTER)),
                             persistent=False)
        common = dict(w_dim=w_dim, resolution=resolution, conv_clamp=conv_clamp, dtype=dtype)
        if in_channels == 0:
            self.const = nn.Parameter(torch.randn(out_channels, resolution, resolution))
        else:
            self.conv0 = SynthesisLayer(in_channels, out_channels, up=2, **common)
        self.conv1 = SynthesisLayer(out_channels, out_channels, **common)
        self.torgb = ToRGBLayer(out_channels, img_channels, w_dim, conv_clamp=conv_clamp)

    @property
    def num_conv(self) -> int:
        return 1 if self.in_channels == 0 else 2

    def forward(self, x, img, ws):
        """ws: [B, num_conv + 1, w_dim]; img fp32 NCHW or None."""
        if self.in_channels == 0:
            x = self.const[None].expand(ws.shape[0], *self.const.shape).to(self.dtype)
        else:
            x = self.conv0(x, ws[:, 0])
        x = self.conv1(x, ws[:, self.num_conv - 1])
        if img is not None:
            img = upsample2d(img, self.resample_filter)
        y = self.torgb(x, ws[:, self.num_conv]).float()
        return x, (img + y if img is not None else y)


class SynthesisNetwork(nn.Module):
    """Progressive synthesis stack (networks_stylegan2.py:465-520): blocks
    ``b4`` ... ``b{img_resolution}``, channels min(channel_base // res,
    channel_max)."""

    def __init__(self, w_dim: int, img_resolution: int, img_channels: int,
                 channel_base: int = 32768, channel_max: int = 512,
                 conv_clamp: Optional[float] = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.block_resolutions = [2 ** i for i in range(2, int(math.log2(img_resolution)) + 1)]
        channels = {r: min(channel_base // r, channel_max) for r in self.block_resolutions}
        for res in self.block_resolutions:
            in_ch = 0 if res == 4 else channels[res // 2]
            self.add_module(f"b{res}", SynthesisBlock(in_ch, channels[res], w_dim, res,
                                                      img_channels, conv_clamp, dtype))
        self.num_ws = sum(getattr(self, f"b{r}").num_conv for r in self.block_resolutions) + 1

    def forward(self, ws):
        x = img = None
        w_idx = 0
        for res in self.block_resolutions:
            block = getattr(self, f"b{res}")
            x, img = block(x, img, ws[:, w_idx:w_idx + block.num_conv + 1])
            w_idx += block.num_conv  # torgb shares the next block's first w (reference :505-508)
        return img


class DecoderMappingNetwork(nn.Module):
    """z -> ws broadcast over ``num_ws``, no 2nd-moment normalization
    (networks_stylegan2.py:903-967): ``num_layers`` lrelu FCs at lr 0.01."""

    def __init__(self, z_dim: int, w_dim: int, num_ws: int, num_layers: int = 8,
                 lr_multiplier: float = 0.01, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_ws = num_ws
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"fc{i}", FullyConnectedLayer(z_dim if i == 0 else w_dim, w_dim,
                                                          activation="lrelu",
                                                          lr_multiplier=lr_multiplier, dtype=dtype))

    def forward(self, z):
        x = z.float()
        for i in range(self.num_layers):
            x = getattr(self, f"fc{i}")(x)
        return x[:, None, :].expand(x.shape[0], self.num_ws, x.shape[1])


class Decoder(nn.Module):
    """Latent -> image; the Discriminator's background reconstructor
    (networks_stylegan2.py:971-994, instantiated networks_detr.py:261 with
    w_dim 512, channel_base 8192, channel_max 512, no noise, no conv
    clamp). z: [B, z_dim] -> fp32 image [B, S, S, img_channels]."""

    def __init__(self, z_dim: int, w_dim: int, img_resolution: int, img_channels: int,
                 channel_base: int = 32768, channel_max: int = 512,
                 conv_clamp: Optional[float] = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.synthesis = SynthesisNetwork(w_dim, img_resolution, img_channels, channel_base,
                                          channel_max, conv_clamp, dtype)
        self.mapping = DecoderMappingNetwork(z_dim, w_dim, self.synthesis.num_ws, dtype=dtype)

    def forward(self, z):
        return self.synthesis(self.mapping(z)).permute(0, 2, 3, 1)
