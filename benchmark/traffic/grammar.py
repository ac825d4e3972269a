"""The banner grammar: stacked, aligned, non-overlapping elements over a
smooth background.

A frozen copy of ``_structured_layout`` and ``_structured_background`` of
the port's synthetic data generator (``data/synthetic.py``), with the same
draws from the same ``numpy.random.Generator`` in the same order. The
background's draws are taken on the host (``background_params``) and the
pages are rendered together on the device (``render_backgrounds``), which
computes the generator's arithmetic in float32 for a whole pool at once.
"""

from __future__ import annotations

import numpy as np
import torch

LABELS = [
    "header", "pre-header", "post-header", "body text",
    "disclaimer / footnote", "button", "callout", "logo",
]

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
# (w_lo, w_hi, h_lo, h_hi) as page fractions, per label
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
_STACK_ORDER = ["pre-header", "header", "post-header", "body text",
                "callout", "button", "disclaimer / footnote"]
MAX_BLOBS = 3


def layout(rng: np.random.Generator, max_elements: int, logo_p: float = 0.6):
    """One page's (bboxes [[xc, yc, w, h]], label indices, strings): 2 to
    min(max_elements, 7) stacked elements, header and button first chosen,
    and a corner logo with probability ``logo_p`` where it fits."""
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
    if max_elements >= len(stack) + 1 and rng.uniform() < logo_p:
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


def background_params(rng: np.random.Generator) -> np.ndarray:
    """The draws of one smooth background, in the generator's order, as one
    row: c0 (3), c1 (3), angle, then ``MAX_BLOBS`` blobs of (active, cx, cy,
    rx, ry, colour (3)); a blob past the drawn count is inactive
    (unit radii, no colour)."""
    c0 = rng.uniform(40, 215, 3)
    c1 = rng.uniform(40, 215, 3)
    angle = rng.uniform(0, 2 * np.pi)
    row = [*c0, *c1, angle]
    n = int(rng.integers(1, 4))
    for i in range(MAX_BLOBS):
        if i < n:
            cx, cy = rng.uniform(0.1, 0.9, 2)
            rx, ry = rng.uniform(0.1, 0.35, 2)
            col = rng.uniform(-60, 60, 3)
            row += [1.0, cx, cy, rx, ry, *col]
        else:
            row += [0.0, 0.5, 0.5, 1.0, 1.0, 0.0, 0.0, 0.0]
    return np.asarray(row, np.float64)


def render_backgrounds(params: np.ndarray, size: int, device) -> torch.Tensor:
    """uint8 [P, size, size, 3] pages from ``background_params`` rows: a
    linear gradient from c0 to c1 along ``angle`` plus soft elliptical
    blobs, clipped to [0, 255]."""
    p = torch.as_tensor(params, dtype=torch.float32, device=device)
    grid = torch.arange(size, dtype=torch.float32, device=device) / size
    y, x = grid[:, None], grid[None, :]
    c0, c1, angle = p[:, 0:3], p[:, 3:6], p[:, 6]
    t = (x[None] * torch.cos(angle)[:, None, None] + y[None] * torch.sin(angle)[:, None, None]
         + 1) / 3
    img = c0[:, None, None, :] + (c1 - c0)[:, None, None, :] * t[..., None]
    for i in range(MAX_BLOBS):
        blob = p[:, 7 + 8 * i: 15 + 8 * i]
        active, cx, cy, rx, ry = (blob[:, j, None, None] for j in range(5))
        shape = torch.exp(-(((x[None] - cx) / rx) ** 2 + ((y[None] - cy) / ry) ** 2))
        img = img + (active * shape)[..., None] * blob[:, None, None, 5:8]
    return img.clamp(0, 255).to(torch.uint8)
