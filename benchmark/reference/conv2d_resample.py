"""2D convolution with fused up/downsampling, NCHW.

Counterpart of ``layoutdetr_tpu/ops/conv2d_resample.py`` (reference
torch_utils/ops/conv2d_resample.py:47-142), with the same branches and
padding arithmetic: the 1x1 reorderings, down-only as FIR then strided
conv, a plain conv when nothing resamples, otherwise the generic
upsample-FIR -> conv -> downsample-FIR composition. An XLA convolution
in the JAX package, not a Pallas kernel; here ``F.conv2d`` and
``upfirdn2d``. Weights are torch's OIHW.
"""

from __future__ import annotations

import torch.nn.functional as F

from .upfirdn2d import _parse_padding, upfirdn2d


def _conv2d(x, w, stride=1, padding=0, groups=1, flip_weight=True):
    """x: [N, Ci, H, W], w: [Co, Ci/groups, kh, kw]. flip_weight=True = correlation."""
    if not flip_weight and (w.shape[2] > 1 or w.shape[3] > 1):
        w = w.flip([2, 3])
    if isinstance(padding, int):
        padding = [padding, padding]
    py, px = padding
    return F.conv2d(x, w, stride=stride, padding=(py, px), groups=groups)


def conv2d_resample(x, w, f=None, up=1, down=1, padding=0, groups=1, flip_weight=True,
                    flip_filter=False):
    """Conv2d with optional up/downsampling (padding applied once, in the
    upsampled image). x: [N, Ci, H, W]; w: [Co, Ci/groups, kh, kw]; f: FIR
    filter from ``setup_filter`` or None."""
    assert x.dim() == 4 and w.dim() == 4
    kh, kw = int(w.shape[2]), int(w.shape[3])
    fw = int(f.shape[-1]) if f is not None else 1
    fh = int(f.shape[0]) if f is not None else 1
    px0, px1, py0, py1 = _parse_padding(padding)

    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2

    if kw == 1 and kh == 1 and down > 1 and up == 1:  # downsample first
        x = upfirdn2d(x, f, down=down, padding=[px0, px1, py0, py1], flip_filter=flip_filter)
        return _conv2d(x, w, groups=groups, flip_weight=flip_weight)
    if kw == 1 and kh == 1 and up > 1 and down == 1:  # convolve first
        x = _conv2d(x, w, groups=groups, flip_weight=flip_weight)
        return upfirdn2d(x, f, up=up, padding=[px0, px1, py0, py1], gain=up ** 2,
                         flip_filter=flip_filter)
    if down > 1 and up == 1:
        x = upfirdn2d(x, f, padding=[px0, px1, py0, py1], flip_filter=flip_filter)
        return _conv2d(x, w, stride=down, groups=groups, flip_weight=flip_weight)
    if up == 1 and down == 1 and px0 == px1 and py0 == py1 and px0 >= 0 and py0 >= 0:
        return _conv2d(x, w, padding=[py0, px0], groups=groups, flip_weight=flip_weight)

    x = upfirdn2d(x, f if up > 1 else None, up=up, padding=[px0, px1, py0, py1],
                  gain=up ** 2, flip_filter=flip_filter)
    x = _conv2d(x, w, groups=groups, flip_weight=flip_weight)
    if down > 1:
        x = upfirdn2d(x, f, down=down, flip_filter=flip_filter)
    return x
