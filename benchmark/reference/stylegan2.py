"""StyleGAN2 pieces of the port: the background decoder and encoder.

Counterpart of ``layoutdetr_tpu/models/stylegan2.py`` (reference
networks_stylegan2.py:23-994): ``FullyConnectedLayer``,
``modulated_conv2d``, ``SynthesisLayer``, ``ToRGBLayer``,
``SynthesisBlock`` ('skip' architecture), ``SynthesisNetwork``,
``DecoderMappingNetwork`` and ``Decoder``, the latter as D instantiates
it (networks_detr.py:261: no noise, no conv clamp); and the encoder stack
of the LayoutGAN++ variant: ``Conv2dLayer``, ``MappingNetwork``,
``DiscriminatorBlock`` ('resnet' and 'skip'), ``MinibatchStdLayer``,
``EncoderEpilogue`` and ``Encoder``, under StyleGAN2's names
(``b256.fromrgb``, ``b256.conv0``, ``b256.conv1``, ``b256.skip``,
``b4.conv``, ``b4.fc``, ``b4.out``).

Every bias + activation goes through ``ops.bias_act`` (a CUDA kernel on
the card, forward and backward). Inside, activations are NCHW and
weights torch's OIHW with the reference's names and shapes (``const``
[C, r, r], ``affine``, ``mapping.fc{i}``), so the state dict reads like
the reference's; ``Decoder`` returns the image channels last,
[B, S, S, 3], as the JAX module does. Modulation runs as scale inputs ->
one shared-weight conv -> demodulate outputs, the JAX package's form.
As in JAX, the ``affine`` layers, the mapping net's ``embed`` and the
encoder epilogue's ``fc`` and ``out`` compute in fp32 whatever ``dtype``
is.
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

from .bias_act import activation_funcs, bias_act
from .conv2d_resample import conv2d_resample
from .upfirdn2d import downsample2d, setup_filter, upsample2d

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
        act_gain = activation_funcs[self.activation][1] * gain
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


class Conv2dLayer(nn.Module):
    """Equalized-LR conv with optional up/down resampling
    (networks_stylegan2.py:131-184): weight [out, in, k, k] ~ N(0, 1)
    scaled at run time by 1 / sqrt(in * k * k), then ``bias_act`` with the
    activation's default gain times ``gain`` and the clamp
    ``conv_clamp * gain``. Without ``bias`` the layer holds no bias and
    ``bias_act`` adds zeros. x: [N, in, H, W], cast to ``dtype``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, bias: bool = True,
                 activation: str = "linear", up: int = 1, down: int = 1,
                 resample_filter: Sequence[int] = RESAMPLE_FILTER,
                 conv_clamp: Optional[float] = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.activation = activation
        self.up = up
        self.down = down
        self.padding = kernel_size // 2
        self.conv_clamp = conv_clamp
        self.compute_dtype = dtype
        self.weight_gain = 1.0 / math.sqrt(in_channels * kernel_size ** 2)
        self.register_buffer("resample_filter", torch.tensor(setup_filter(resample_filter)),
                             persistent=False)
        self.weight = nn.Parameter(torch.randn(out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x, gain: float = 1.0):
        dt = self.compute_dtype
        x = conv2d_resample(x.to(dt), (self.weight * self.weight_gain).to(dt),
                            f=self.resample_filter, up=self.up, down=self.down,
                            padding=self.padding, flip_weight=(self.up == 1))
        b = None if self.bias is None else self.bias.to(x.dtype)
        act_gain = activation_funcs[self.activation][1] * gain
        act_clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return bias_act(x, b, dim=1, act=self.activation, gain=act_gain, clamp=act_clamp)


class MappingNetwork(nn.Module):
    """z (and an optional label c) -> w (networks_stylegan2.py:189-267):
    2nd-moment normalized z, ``embed`` of c (fp32) normalized and
    concatenated, ``num_layers`` lrelu FCs at ``lr_multiplier``; broadcast
    over ``num_ws`` unless it is None. The JAX package's form: no ``w_avg``
    tracking and no truncation."""

    def __init__(self, z_dim: int, c_dim: int, w_dim: int, num_ws: Optional[int],
                 num_layers: int = 8, lr_multiplier: float = 0.01,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.z_dim, self.c_dim = z_dim, c_dim
        self.num_ws = num_ws
        self.num_layers = num_layers
        if c_dim > 0:
            self.embed = FullyConnectedLayer(c_dim, w_dim)
        in_features = z_dim + (w_dim if c_dim > 0 else 0)
        for i in range(num_layers):
            self.add_module(f"fc{i}", FullyConnectedLayer(in_features if i == 0 else w_dim, w_dim,
                                                          activation="lrelu",
                                                          lr_multiplier=lr_multiplier, dtype=dtype))

    def forward(self, z, c=None):
        x = normalize_2nd_moment(z.float()) if self.z_dim > 0 else None
        if self.c_dim > 0:
            y = normalize_2nd_moment(self.embed(c.float()))
            x = torch.cat([x, y], dim=1) if x is not None else y
        for i in range(self.num_layers):
            x = getattr(self, f"fc{i}")(x)
        if self.num_ws is not None:
            x = x[:, None, :].expand(x.shape[0], self.num_ws, x.shape[1])
        return x


class DiscriminatorBlock(nn.Module):
    """One downsampling level (networks_stylegan2.py:553-634). ``in_channels``
    0 = the first block, which reads the image through ``fromrgb``; so does
    every block of the 'skip' architecture, which also downsamples the
    image for the next. 'resnet' adds a bias-less 1x1 ``skip`` (gain
    sqrt(1/2)) to conv1's output (also at gain sqrt(1/2))."""

    def __init__(self, in_channels: int, tmp_channels: int, out_channels: int,
                 img_channels: int = 3, architecture: str = "resnet", activation: str = "lrelu",
                 resample_filter: Sequence[int] = RESAMPLE_FILTER,
                 conv_clamp: Optional[float] = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_channels = in_channels
        self.architecture = architecture
        self.register_buffer("resample_filter", torch.tensor(setup_filter(resample_filter)),
                             persistent=False)
        common = dict(activation=activation, conv_clamp=conv_clamp, dtype=dtype)
        if in_channels == 0 or architecture == "skip":
            self.fromrgb = Conv2dLayer(img_channels, tmp_channels, 1, **common)
        if architecture == "resnet":
            self.skip = Conv2dLayer(tmp_channels, out_channels, 1, bias=False, down=2,
                                    resample_filter=resample_filter, dtype=dtype)
        self.conv0 = Conv2dLayer(tmp_channels, tmp_channels, 3, **common)
        self.conv1 = Conv2dLayer(tmp_channels, out_channels, 3, down=2,
                                 resample_filter=resample_filter, **common)

    def forward(self, x, img):
        """x: [N, C, H, W] or None (the first block); img: [N, 3, H, W] or
        None. Returns (x at half the resolution, img for the next block)."""
        if self.in_channels == 0 or self.architecture == "skip":
            y = self.fromrgb(img)
            x = x + y if x is not None else y
            img = downsample2d(img, self.resample_filter) if self.architecture == "skip" else None
        if self.architecture == "resnet":
            y = self.skip(x, gain=math.sqrt(0.5))
            x = self.conv0(x)
            x = self.conv1(x, gain=math.sqrt(0.5))
            return y + x, img
        return self.conv1(self.conv0(x)), img


class MinibatchStdLayer(nn.Module):
    """Cross-sample standard-deviation features (networks_stylegan2.py:642-666)
    appended as ``num_channels`` maps. As in the JAX module, sample i takes
    the statistic of subgroup i // group_size (``jnp.repeat``), where the
    reference's ``repeat`` tiles them (i % (N // group_size)); the two agree
    when N <= group_size. Nothing in the models calls it (JAX's ``Encoder``
    does not either)."""

    def __init__(self, group_size: Optional[int] = 4, num_channels: int = 1):
        super().__init__()
        self.group_size = group_size
        self.num_channels = num_channels

    def forward(self, x):
        n, c, h, w = x.shape
        g = min(self.group_size, n) if self.group_size is not None else n
        f = self.num_channels
        y = x.reshape(g, -1, f, c // f, h, w)
        y = y - y.mean(dim=0)
        y = y.square().mean(dim=0)
        y = torch.sqrt(y + 1e-8)
        y = y.mean(dim=(2, 3, 4))  # [N // g, F]
        y = y.repeat_interleave(g, dim=0)[:, :, None, None].expand(n, f, h, w)
        return torch.cat([x, y.to(x.dtype)], dim=1)


class EncoderEpilogue(nn.Module):
    """The 4x4 level -> embedding (networks_stylegan2.py:797-840): (with
    'skip') ``fromrgb`` added, ``conv`` 3x3, flattened in NCHW order, then
    the fp32 FCs ``fc`` (activation) and ``out`` (linear). Returns fp32
    [N, out_channels]."""

    def __init__(self, in_channels: int, out_channels: int, resolution: int = 4,
                 img_channels: int = 3, architecture: str = "resnet", activation: str = "lrelu",
                 conv_clamp: Optional[float] = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.architecture = architecture
        if architecture == "skip":
            self.fromrgb = Conv2dLayer(img_channels, in_channels, 1, activation=activation,
                                       dtype=dtype)
        self.conv = Conv2dLayer(in_channels, in_channels, 3, activation=activation,
                                conv_clamp=conv_clamp, dtype=dtype)
        self.fc = FullyConnectedLayer(in_channels * resolution ** 2, in_channels,
                                      activation=activation)
        self.out = FullyConnectedLayer(in_channels, out_channels)

    def forward(self, x, img):
        if self.architecture == "skip":
            x = x + self.fromrgb(img)
        x = self.conv(x)
        return self.out(self.fc(x.flatten(1)))


def encoder_resolutions(img_resolution: int) -> list:
    """``Encoder``'s block resolutions, largest (``img_resolution`` rounded
    up to a power of 2) first, down to 8."""
    return [2 ** i for i in range(int(math.ceil(math.log2(img_resolution))), 2, -1)]


class Encoder(nn.Module):
    """Image -> embedding (networks_stylegan2.py:848-898): blocks
    ``b{res}`` from ``img_resolution`` (rounded up to a power of 2) down to
    8, channels min(channel_base // res, channel_max), then the epilogue
    ``b4``. img: [N, img_channels, S, S] -> fp32 [N, out_channels]. As in
    JAX, no minibatch-stddev layer runs."""

    def __init__(self, img_resolution: int, out_channels: int, img_channels: int = 3,
                 architecture: str = "resnet", channel_base: int = 32768, channel_max: int = 512,
                 conv_clamp: Optional[float] = 256.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.block_resolutions = encoder_resolutions(img_resolution)
        channels = {res: min(channel_base // res, channel_max)
                    for res in self.block_resolutions + [4]}
        for res in self.block_resolutions:
            in_ch = channels[res] if res < self.block_resolutions[0] else 0
            self.add_module(f"b{res}", DiscriminatorBlock(
                in_ch, channels[res], channels[res // 2], img_channels, architecture,
                conv_clamp=conv_clamp, dtype=dtype))
        self.b4 = EncoderEpilogue(channels[4], out_channels, img_channels=img_channels,
                                  architecture=architecture, conv_clamp=conv_clamp, dtype=dtype)

    def forward(self, img):
        x = None
        for res in self.block_resolutions:
            x, img = getattr(self, f"b{res}")(x, img)
        return self.b4(x, img)
