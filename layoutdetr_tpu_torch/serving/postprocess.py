"""Layout post-processing + bbox overlay rendering (host-side numpy).

A copy of ``layoutdetr_tpu/serving/postprocess.py``, so that the port
imports nothing of the JAX package; PIL is imported only by the drawing
function.

Parity target: generate.py:67-137 (save_bboxes_with_background, jitter,
horizontal_center_aligned, horizontal_left_aligned, de_overlap) and the
random post-processing selection at generate.py:313-319 — with the
reference's `==`-instead-of-`=` bug FIXED (random mode actually picks a
branch here; the reference always fell through, SURVEY.md §7 quirks).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

LABEL_LIST = [
    "header", "pre-header", "post-header", "body text",
    "disclaimer / footnote", "button", "callout", "logo",
]
LABEL2INDEX = {label: i for i, label in enumerate(LABEL_LIST)}


def label_palette(n_colors: int = 13):
    """Distinct label colors: the husl palette the reference renders with
    (generate.py:69 seaborn color_palette('husl')), via the self-contained
    HUSL implementation in utils/husl.py."""
    from layoutdetr_tpu_torch.utils.husl import husl_palette

    return [tuple(int(x * 255) for x in c) for c in husl_palette(n_colors)]


def convert_xywh_to_ltrb(bbox):
    xc, yc, w, h = bbox
    return xc - w / 2, yc - h / 2, xc + w / 2, yc + h / 2


def jitter(bbox_fake: np.ndarray, strength: float, seed: int) -> np.ndarray:
    """Log-uniform multiplicative jitter (generate.py:88-91)."""
    perturb = np.random.RandomState(seed).uniform(
        low=math.log(1.0 - strength), high=math.log(1.0 + strength), size=bbox_fake.shape
    ).astype(np.float32)
    return bbox_fake * np.exp(perturb)


def horizontal_center_aligned(bbox_fake: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Set every xc to the mean valid xc (generate.py:95-98)."""
    out = bbox_fake.copy()
    out[:, :, 0] = out[mask][:, 0].mean()
    return out


def horizontal_left_aligned(bbox_fake: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Shift boxes so left edges align at the mean left edge (generate.py:100-110)."""
    out = bbox_fake.copy()
    num = int(mask.sum())
    lefts = [convert_xywh_to_ltrb(out[0, i])[0] for i in range(num)]
    x1_mean = float(np.sum(lefts)) / float(num)
    for i in range(num):
        out[0, i, 0] -= lefts[i] - x1_mean
    return out


def de_overlap(bbox_fake: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Push vertically-overlapping boxes apart, then shrink remaining
    overlaps (generate.py:112-137)."""
    out = bbox_fake.copy()
    num = int(mask.sum())
    for i in range(num):
        for j in range(num):
            if i == j:
                continue
            yc1, h1 = out[0, i, 1], out[0, i, 3]
            yc2, h2 = out[0, j, 1], out[0, j, 3]
            if abs(yc2 - yc1) < h1 / 2 + h2 / 2:
                diff = h1 / 2 + h2 / 2 - abs(yc2 - yc1)
                if yc1 < yc2:
                    out[0, i, 1] -= diff / 2
                    out[0, j, 1] += diff / 2
                else:
                    out[0, i, 1] += diff / 2
                    out[0, j, 1] -= diff / 2
    for i in range(num):
        for j in range(num):
            if i == j:
                continue
            yc1, h1 = out[0, i, 1], out[0, i, 3]
            yc2, h2 = out[0, j, 1], out[0, j, 3]
            if abs(yc2 - yc1) < h1 / 2 + h2 / 2:
                diff = h1 / 2 + h2 / 2 - abs(yc2 - yc1)
                out[0, i, 3] -= diff / 2
                out[0, j, 3] -= diff / 2
    return out


def apply_postprocessing(bbox_fake: np.ndarray, mask: np.ndarray, mode: str,
                         rng: Optional[np.random.RandomState] = None):
    """Returns (bbox, bbox_alignment). mode='none' picks randomly
    (generate.py:313-319, with the no-op `==` bug fixed)."""
    if mode == "none":
        rng = rng or np.random.RandomState()
        rand_val = rng.random_sample()
        if rand_val < 0.34:
            mode = "horizontal_center_aligned"
        elif rand_val < 0.67:
            mode = "horizontal_left_aligned"
    if mode == "horizontal_center_aligned":
        return de_overlap(horizontal_center_aligned(bbox_fake, mask), mask), True
    if mode == "horizontal_left_aligned":
        return de_overlap(horizontal_left_aligned(bbox_fake, mask), mask), False
    return bbox_fake, True


def save_bboxes_with_background(boxes, masks, labels, background_orig, path: str) -> None:
    """Draw labeled translucent boxes over the background PIL image
    (generate.py:67-84)."""
    import PIL.ImageDraw

    colors = label_palette(13)
    img = background_orig.copy()
    w_page, h_page = img.size
    draw = PIL.ImageDraw.Draw(img, "RGBA")
    boxes = np.asarray(boxes)[np.asarray(masks)]
    labels = np.asarray(labels)[np.asarray(masks)]
    areas = [b[2] * b[3] for b in boxes]
    for i in sorted(range(len(areas)), key=lambda k: areas[k], reverse=True):
        color = colors[int(labels[i]) % len(colors)]
        x1, y1, x2, y2 = convert_xywh_to_ltrb(boxes[i])
        draw.rectangle(
            [x1 * w_page, y1 * h_page, x2 * w_page, y2 * h_page],
            outline=color, fill=color + (100,),
        )
    img.save(path, format="png", compress_level=0, optimize=False)
