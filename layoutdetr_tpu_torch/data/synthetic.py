"""Synthetic dataset builder for tests and the card's smoke run.

A copy of ``layoutdetr_tpu/data/synthetic.py``, so that the port imports
nothing of the JAX package; the same seed writes the same zip. The zip
has the on-disk format of dataset_tool.py (reference:
dataset_tool.py:313-363 — non_image.json 'samples' list + per-element
patch PNGs + background PNG), so the runtime loader and any
reference-compatible consumer can read it.
"""

from __future__ import annotations

import io
import json
import zipfile

import numpy as np
import PIL.Image

LABELS = [
    "header", "pre-header", "post-header", "body text",
    "disclaimer / footnote", "button", "callout", "logo",
]

_WORDS = ["shop", "now", "sale", "fresh", "deal", "save", "today", "new", "big", "free"]

# Structured mode: label-conditioned word pools and geometry priors so a
# GAN trained on the synthetic set has real signal to fit (stacked,
# aligned, non-overlapping banner grammar — random uniform boxes give
# the alignment/overlap/FID losses nothing to learn).
_POOL = {
    "header": ["summer sale", "new arrivals", "big deal days", "fresh picks",
               "final clearance", "members only"],
    "pre-header": ["limited time", "this week only", "online exclusive"],
    "post-header": ["up to 50% off", "free shipping over $50", "while stocks last"],
    "body text": ["save big on everything you love this season",
                  "discover deals across every department today",
                  "quality picks at prices that make sense"],
    "disclaimer / footnote": ["terms and conditions apply", "exclusions apply see details"],
    "button": ["shop now", "buy today", "learn more", "get the deal"],
    "callout": ["hot", "new", "sale"],
    "logo": ["acme", "zenith", "orbit"],
}
# (w_lo, w_hi, h_lo, h_hi) as page fractions, per label.
_GEOM = {
    "header": (0.50, 0.80, 0.10, 0.16),
    "pre-header": (0.30, 0.50, 0.04, 0.06),
    "post-header": (0.35, 0.55, 0.05, 0.08),
    "body text": (0.40, 0.70, 0.08, 0.14),
    "disclaimer / footnote": (0.30, 0.60, 0.03, 0.05),
    "button": (0.18, 0.30, 0.06, 0.09),
    "callout": (0.10, 0.18, 0.05, 0.08),
    "logo": (0.10, 0.16, 0.06, 0.10),
}
# Top-to-bottom stacking order of the grammar.
_STACK_ORDER = ["pre-header", "header", "post-header", "body text",
                "callout", "button", "disclaimer / footnote"]


def _structured_background(rng, image_size: int) -> np.ndarray:
    """Smooth gradient + soft blobs: low-frequency content the D's
    bg_decoder can actually reconstruct (noise pins bg_rec at variance)."""
    y, x = np.mgrid[0:image_size, 0:image_size].astype(np.float32) / image_size
    c0 = rng.uniform(40, 215, 3).astype(np.float32)
    c1 = rng.uniform(40, 215, 3).astype(np.float32)
    angle = rng.uniform(0, 2 * np.pi)
    t = (x * np.cos(angle) + y * np.sin(angle) + 1) / 3  # in [0, ~0.9]
    img = c0[None, None] + (c1 - c0)[None, None] * t[..., None]
    for _ in range(int(rng.integers(1, 4))):  # soft elliptical blobs
        cx, cy = rng.uniform(0.1, 0.9, 2)
        rx, ry = rng.uniform(0.1, 0.35, 2)
        blob = np.exp(-(((x - cx) / rx) ** 2 + ((y - cy) / ry) ** 2))
        col = rng.uniform(-60, 60, 3).astype(np.float32)
        img += blob[..., None] * col[None, None]
    return np.clip(img, 0, 255).astype(np.uint8)


def _structured_layout(rng, max_elements: int):
    """One banner-grammar layout: (bboxes, labels, texts) in the
    normalized [xc, yc, w, h] page convention (dataset_tool.py:197-202)."""
    align = rng.choice(["center", "left"])
    x_left = float(rng.uniform(0.06, 0.18))
    n_budget = int(rng.integers(2, max(3, min(max_elements, 7) + 1)))
    n_budget = min(n_budget, max_elements)
    chosen = [l for l in _STACK_ORDER if l in ("header", "button")][:n_budget]
    optional = [l for l in _STACK_ORDER if l not in chosen]
    rng.shuffle(optional)
    chosen += optional[: max(0, n_budget - len(chosen))]
    stack = [l for l in _STACK_ORDER if l in chosen]

    bboxes, labels, texts = [], [], []
    yc_cursor = float(rng.uniform(0.08, 0.22))
    # Corner logo decided first: the stack starts below its band so the
    # grammar never produces overlapping elements.
    if max_elements >= len(stack) + 1 and rng.uniform() < 0.6:
        w_lo, w_hi, h_lo, h_hi = _GEOM["logo"]
        w = float(rng.uniform(w_lo, w_hi))
        h = float(rng.uniform(h_lo, h_hi))
        corner_x = rng.choice([0.06 + w / 2, 0.94 - w / 2])
        bboxes.append([float(corner_x), 0.05 + h / 2, w, h])
        labels.append(LABELS.index("logo"))
        texts.append(str(rng.choice(_POOL["logo"])))
        yc_cursor = max(yc_cursor, 0.05 + h + 0.02)
    for name in stack:
        w_lo, w_hi, h_lo, h_hi = _GEOM[name]
        w = float(rng.uniform(w_lo, w_hi))
        h = float(rng.uniform(h_lo, h_hi))
        if yc_cursor + h > 0.96:
            break
        xc = 0.5 if align == "center" else min(x_left + w / 2, 1 - w / 2)
        bboxes.append([float(xc), yc_cursor + h / 2, w, h])
        labels.append(LABELS.index(name))
        texts.append(str(rng.choice(_POOL[name])))
        yc_cursor += h + float(rng.uniform(0.015, 0.05))
    return bboxes, labels, texts


def _png_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    PIL.Image.fromarray(arr).save(buf, format="png", compress_level=0)
    return buf.getvalue()


def make_synthetic_zip(path: str, num_samples: int = 4, image_size: int = 64,
                       max_elements: int = 4, seed: int = 0,
                       structured: bool = False) -> str:
    """``structured=True`` draws banner-grammar layouts over gradient
    backgrounds (learnable signal for long training runs); the default
    draws uniform-random boxes over noise (cheap unit-test fixture)."""
    rng = np.random.default_rng(seed)
    samples = []
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        for s in range(num_samples):
            base = f"{s:08d}"
            if structured:
                bboxes, labels, texts = _structured_layout(rng, max_elements)
            else:
                bboxes, labels, texts = [], [], []
                for _ in range(int(rng.integers(1, max_elements + 1))):
                    w, h = rng.uniform(0.1, 0.4, 2)
                    xc = rng.uniform(w / 2, 1 - w / 2)
                    yc = rng.uniform(h / 2, 1 - h / 2)
                    bboxes.append([float(xc), float(yc), float(w), float(h)])
                    labels.append(int(rng.integers(0, len(LABELS))))
                    texts.append(" ".join(rng.choice(_WORDS, rng.integers(1, 5))))
            for i in range(len(bboxes)):
                patch = rng.integers(0, 255, (32, 32, 3), np.uint8)
                zf.writestr(f"{base}_{i}_patch.png", _png_bytes(patch))
                zf.writestr(f"{base}_{i}_patch_orig.png", _png_bytes(patch))
                zf.writestr(f"{base}_{i}_patch_mask.png",
                            _png_bytes(np.full((32, 32), 255, np.uint8)))
            if structured:
                bg = _structured_background(rng, image_size)
            else:
                bg = rng.integers(0, 255, (image_size, image_size, 3), np.uint8)
            zf.writestr(f"{base}_background_orig.png", _png_bytes(bg))
            attr = {"name": base, "width": 512, "height": 512,
                    "num_bbox_labels": len(LABELS), "filtered": False,
                    "has_canvas_element": False}
            samples.append([base, {"attr": attr, "bboxes": bboxes, "labels": labels,
                                   "texts": texts, "page_label": None}])
        zf.writestr("non_image.json", json.dumps({"samples": samples}))
    return path
