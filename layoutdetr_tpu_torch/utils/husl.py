"""HUSL (HSLuv) color space conversion — self-contained.

A copy of ``layoutdetr_tpu/utils/husl.py`` for the port's overlay colors.

The reference colors its bbox overlays with seaborn's husl palette
(generate.py:69, dataset_layoutganpp.py:183-187); seaborn is not in
this image, so this implements the standard HUSL→RGB conversion
(public-domain algorithm, www.hsluv.org) to produce identical palettes.
"""

from __future__ import annotations

import math
from typing import List, Tuple

_M = [
    [3.240969941904521, -1.537383177570093, -0.498610760293],
    [-0.96924363628087, 1.87596750150772, 0.041555057407175],
    [0.055630079696993, -0.20397695888897, 1.056971514242878],
]
_REF_Y = 1.0
_REF_U = 0.19783000664283
_REF_V = 0.46831999493879
_KAPPA = 903.2962962
_EPSILON = 0.0088564516


def _get_bounds(l: float) -> List[Tuple[float, float]]:
    result = []
    sub1 = ((l + 16.0) ** 3) / 1560896.0
    sub2 = sub1 if sub1 > _EPSILON else l / _KAPPA
    for c in range(3):
        m1, m2, m3 = _M[c]
        for t in range(2):
            top1 = (284517.0 * m1 - 94839.0 * m3) * sub2
            top2 = ((838422.0 * m3 + 769860.0 * m2 + 731718.0 * m1) * l * sub2
                    - 769860.0 * t * l)
            bottom = (632260.0 * m3 - 126452.0 * m2) * sub2 + 126452.0 * t
            result.append((top1 / bottom, top2 / bottom))
    return result


def _max_chroma_for_lh(l: float, h: float) -> float:
    hrad = math.radians(h)
    lengths = []
    for line in _get_bounds(l):
        m, b = line
        denom = math.sin(hrad) - m * math.cos(hrad)
        if denom != 0:
            length = b / denom
            if length >= 0:
                lengths.append(length)
    return min(lengths) if lengths else 0.0


def _lch_to_luv(l: float, c: float, h: float):
    hrad = math.radians(h)
    return l, math.cos(hrad) * c, math.sin(hrad) * c


def _luv_to_xyz(l: float, u: float, v: float):
    if l == 0:
        return 0.0, 0.0, 0.0
    var_u = u / (13.0 * l) + _REF_U
    var_v = v / (13.0 * l) + _REF_V
    y = _REF_Y * (((l + 16.0) / 116.0) ** 3 if l > 8 else l / _KAPPA)
    if l <= 8:
        y = _REF_Y * l / _KAPPA
    else:
        y = _REF_Y * (((l + 16.0) / 116.0) ** 3)
    x = 0.0 - (9.0 * y * var_u) / ((var_u - 4.0) * var_v - var_u * var_v)
    z = (9.0 * y - (15.0 * var_v * y) - (var_v * x)) / (3.0 * var_v)
    return x, y, z


def _from_linear(c: float) -> float:
    if c <= 0.0031308:
        return 12.92 * c
    return 1.055 * (c ** (1.0 / 2.4)) - 0.055


def _xyz_to_rgb(x: float, y: float, z: float):
    return tuple(
        _from_linear(_M[i][0] * x + _M[i][1] * y + _M[i][2] * z) for i in range(3)
    )


def husl_to_rgb(h: float, s: float, l: float):
    """HUSL (h in [0,360], s/l in [0,100]) -> RGB floats in [0,1]."""
    if l > 99.9999999:
        return (1.0, 1.0, 1.0)
    if l < 0.00000001:
        return (0.0, 0.0, 0.0)
    c = _max_chroma_for_lh(l, h) / 100.0 * s
    luv = _lch_to_luv(l, c, h)
    rgb = _xyz_to_rgb(*_luv_to_xyz(*luv))
    return tuple(min(max(v, 0.0), 1.0) for v in rgb)


def husl_palette(n_colors: int, h: float = 0.01, s: float = 0.9, l: float = 0.65):
    """seaborn.husl_palette semantics: n evenly-spaced hues."""
    hues = [(i / n_colors + h) % 1.0 for i in range(n_colors)]
    return [husl_to_rgb(hue * 359.0, s * 99.0, l * 99.0) for hue in hues]
