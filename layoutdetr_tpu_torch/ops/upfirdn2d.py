"""upfirdn2d: pad -> zero-insert upsample -> FIR filter -> downsample, NCHW.

Counterpart of ``layoutdetr_tpu/ops/upfirdn2d.py`` (reference
torch_utils/ops/upfirdn2d.py:71-389). In the JAX package this is one XLA
convolution, not a Pallas kernel, and here it is a composition of torch
ops: zero-stuffing by reshape and pad (which gives the reference's
``h * up`` samples, trailing ``up - 1`` zeros included), padding with
negative pads cropping, then a depthwise ``F.conv2d`` (``groups=C``) with
the flipped filter, its stride doing the downsampling (a separable 1-D
filter runs as two passes and downsamples by slicing afterwards).
Layout is torch's NCHW; the filters are those of ``setup_filter``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _parse_scaling(scaling):
    if isinstance(scaling, int):
        scaling = [scaling, scaling]
    sx, sy = scaling
    assert sx >= 1 and sy >= 1
    return int(sx), int(sy)


def _parse_padding(padding):
    if isinstance(padding, int):
        padding = [padding, padding]
    padding = list(padding)
    if len(padding) == 2:
        padx, pady = padding
        padding = [padx, padx, pady, pady]
    px0, px1, py0, py1 = padding
    return int(px0), int(px1), int(py0), int(py1)


def setup_filter(f, normalize=True, flip_filter=False, gain=1, separable=None) -> np.ndarray:
    """Prepare a FIR filter (reference upfirdn2d.py:71-115); float32 ndarray."""
    if f is None:
        f = 1
    f = np.asarray(f, dtype=np.float32)
    assert f.ndim in (0, 1, 2) and f.size > 0
    if f.ndim == 0:
        f = f[np.newaxis]
    if separable is None:
        separable = f.ndim == 1 and f.size >= 8
    if f.ndim == 1 and not separable:
        f = np.outer(f, f)
    assert f.ndim == (1 if separable else 2)
    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = np.flip(f).copy()
    return f * (gain ** (f.ndim / 2))


def _depthwise(x, f2d: torch.Tensor, stride=(1, 1)):
    c = x.shape[1]
    w = f2d.to(x.dtype)[None, None].expand(c, 1, *f2d.shape)
    return F.conv2d(x, w, stride=stride, groups=c)


def upfirdn2d(x, f, up=1, down=1, padding=0, flip_filter=False, gain=1):
    """Pad, upsample, FIR-filter and downsample a batch of NCHW images.

    x: [N, C, H, W]; f: filter [fh, fw], separable [taps], or None (an
    array, or a tensor, best already on x's device: copying a host filter
    to the card makes the host wait for the stream);
    up/down: int or (x, y); padding: int, (x, y) or (x0, x1, y0, y1) in
    the upsampled image, negative = crop; flip_filter: False =
    convolution, True = correlation; gain: overall scaling."""
    assert x.dim() == 4
    f = torch.ones(1, 1, device=x.device) if f is None else torch.as_tensor(f)
    f = f.to(device=x.device, dtype=torch.float32)
    assert f.dim() in (1, 2)
    upx, upy = _parse_scaling(up)
    downx, downy = _parse_scaling(down)
    px0, px1, py0, py1 = _parse_padding(padding)

    n, c, h, w = x.shape
    if upx > 1 or upy > 1:  # zero-stuff: h * up samples, up - 1 trailing zeros
        x = x.reshape(n, c, h, 1, w, 1)
        x = F.pad(x, [0, upx - 1, 0, 0, 0, upy - 1])
        x = x.reshape(n, c, h * upy, w * upx)
    x = F.pad(x, [max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)])
    x = x[:, :, max(-py0, 0): x.shape[2] - max(-py1, 0), max(-px0, 0): x.shape[3] - max(-px1, 0)]

    f = f * (gain ** (f.dim() / 2))
    if not flip_filter:
        f = f.flip(list(range(f.dim())))
    if f.dim() == 1:
        x = _depthwise(x, f[None, :])
        x = _depthwise(x, f[:, None])
        return x[:, :, ::downy, ::downx]
    return _depthwise(x, f, stride=(downy, downx))


def upsample2d(x, f, up=2, padding=0, flip_filter=False, gain=1):
    """Upsample with the given filter (reference upfirdn2d.py:314-350)."""
    upx, upy = _parse_scaling(up)
    px0, px1, py0, py1 = _parse_padding(padding)
    fw = int(f.shape[-1]) if f is not None else 1
    fh = int(f.shape[0]) if f is not None else 1
    px0 += (fw + upx - 1) // 2
    px1 += (fw - upx) // 2
    py0 += (fh + upy - 1) // 2
    py1 += (fh - upy) // 2
    return upfirdn2d(x, f, up=up, padding=[px0, px1, py0, py1], flip_filter=flip_filter,
                     gain=gain * upx * upy)
