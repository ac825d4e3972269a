"""A production-shaped source tree for the dataset tool, at the reference's scale.

    python -m layoutdetr_tpu_torch.production_source --out DIR [--pages 7672] [--seed 0] \
        [--png-compress 3] [--workers N]

The port's counterpart of ``tools/make_production_source.py``. It writes
the input layout of the dataset tool (reference dataset_tool.py:83-243):

    DIR/png_json_gt/<name>.png + <name>.json
    DIR/1x_inpainted_background_png/<name>_inpainted.png

``--pages`` pages (default 7,672, the reference dataset's size) of IAB
banner sizes up to 1024 px, 1-9 elements each from the banner grammar,
the elements' pixels rendered over the page (so every patch has content)
and the background without them (what inpainting gives). For the same
seed the tree is the JAX tool's: the same names, equal JSON and equal PNG
pixels.

One random stream draws every page in order, as the JAX tool does; the
pixels, the rendering and the PNG encoding, which take the time, run in
``--workers`` processes (default: the host's cores). Each page's draws
are taken in the JAX tool's order before its pixels are made, so the
stream, and the tree, do not depend on the worker count.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from concurrent.futures import ProcessPoolExecutor
from typing import Optional, Sequence

import numpy as np
import PIL.Image
import PIL.ImageDraw

from layoutdetr_tpu_torch.data.synthetic import _POOL, _STACK_ORDER

LABELS = list(_POOL)

# Banner formats (w, h): IAB standards and square/social crops, all sides
# <= 1024 (the dataset tool keeps element sides <= 1024, reference
# dataset_tool.py:135-157).
FORMATS = [
    (300, 250), (336, 280), (728, 90), (970, 250), (160, 600), (300, 600),
    (320, 480), (480, 320), (640, 640), (800, 800), (1024, 512), (512, 1024),
    (1024, 1024), (600, 500), (960, 640),
]


def _blob_draws(rng, w, h) -> list:
    """The background's draws: 2-4 soft blobs as (cx, cy, r, colour)."""
    blobs = []
    for _ in range(int(rng.integers(2, 5))):
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
        r = rng.uniform(0.15, 0.45) * max(w, h)
        blobs.append((cx, cy, r, rng.uniform(-60, 60, 3)))
    return blobs


def _paint_background(w, h, blobs) -> np.ndarray:
    """A smooth gradient plus the soft blobs at page resolution (content
    an inpainter would plausibly produce), uint8 [h, w, 3]."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([
        90 + 120 * xx / max(w, 1),
        60 + 110 * yy / max(h, 1),
        140 + 80 * (xx + yy) / max(w + h, 1),
    ], axis=-1)
    for cx, cy, r, colour in blobs:
        blob = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * r * r))
        base += blob[..., None] * colour
    return np.clip(base, 0, 255).astype(np.uint8)


def _background(rng, w, h) -> np.ndarray:
    return _paint_background(w, h, _blob_draws(rng, w, h))


def _layout(rng, w, h) -> list:
    """A grammar layout in pixels for a (w, h) page: stacked, in the page,
    not overlapping; 1-9 elements."""
    elements = []
    margin = 0.04
    y = margin + rng.uniform(0, 0.05)
    order = [l for l in _STACK_ORDER if rng.random() < 0.75]
    if not order:
        order = ["header"]
    if "header" not in order and rng.random() < 0.8:
        order.insert(0, "header")
    logo = rng.random() < 0.5
    for label in order[:8]:
        fw = rng.uniform(0.25, 0.8)
        fh = rng.uniform(0.05, 0.16)
        if y + fh > 1 - margin:
            break
        xc = 0.5 if rng.random() < 0.6 else rng.uniform(fw / 2 + margin, 1 - fw / 2 - margin)
        x1, x2 = (xc - fw / 2) * w, (xc + fw / 2) * w
        y1, y2 = y * h, (y + fh) * h
        # the validity filter needs integer boxes of >= ~3 px after the
        # 256 resize: boxes under 8 px are skipped
        if x2 - x1 < 8 or y2 - y1 < 8:
            continue
        text = str(rng.choice(_POOL[label]))
        elements.append({"xyxy_word_fit": [float(x1), float(y1), float(x2), float(y2)],
                         "label": label, "str": text})
        y += fh + rng.uniform(0.01, 0.04)
    if logo and len(elements) < 9:
        lw, lh = 0.14 * w, 0.10 * h
        if lw >= 8 and lh >= 8:
            elements.append({"xyxy_word_fit": [w - lw - 4, 4, w - 4, lh + 4],
                             "label": "logo", "str": str(rng.choice(_POOL["logo"]))})
    return elements[:9]


def _draw_elements(bg_u8, elements, lights) -> np.ndarray:
    """The elements drawn over the background (text-like bars and button
    pills, light or dark), so crops and patches have real content."""
    img = PIL.Image.fromarray(bg_u8.copy())
    draw = PIL.ImageDraw.Draw(img)
    for e, light in zip(elements, lights):
        x1, y1, x2, y2 = [int(v) for v in e["xyxy_word_fit"]]
        fill = (245, 245, 245) if light else (20, 20, 30)
        fg = (20, 20, 30) if light else (245, 245, 245)
        if e["label"] == "button":
            draw.rounded_rectangle([x1, y1, x2, y2], radius=(y2 - y1) // 2, fill=fill)
        else:
            draw.rectangle([x1, y1, x2, y2], fill=fill)
        try:
            draw.text((x1 + 4, y1 + max(0, (y2 - y1) // 4)), e["str"], fill=fg)
        except Exception:
            pass
    return np.asarray(img)


def _render(bg_u8, elements, rng) -> np.ndarray:
    return _draw_elements(bg_u8, elements, [rng.random() < 0.5 for _ in elements])


def page_draws(rng, pages: int):
    """Each page's draws, in the JAX tool's order: (index, w, h, blobs,
    elements, lights)."""
    for i in range(pages):
        w, h = FORMATS[int(rng.integers(0, len(FORMATS)))]
        blobs = _blob_draws(rng, w, h)
        elements = _layout(rng, w, h)
        yield i, w, h, blobs, elements, [rng.random() < 0.5 for _ in elements]


def _write_page(out: str, png_compress: int, draws) -> None:
    i, w, h, blobs, elements, lights = draws
    bg = _paint_background(w, h, blobs)
    page = _draw_elements(bg, elements, lights)
    name = f"page{i:06d}"
    gt = os.path.join(out, "png_json_gt")
    PIL.Image.fromarray(page).save(os.path.join(gt, name + ".png"), compress_level=png_compress)
    with open(os.path.join(gt, name + ".json"), "w") as f:
        json.dump(elements, f)
    PIL.Image.fromarray(bg).save(os.path.join(out, "1x_inpainted_background_png",
                                              name + "_inpainted.png"),
                                 compress_level=png_compress)


def _write_chunk(out: str, png_compress: int, chunk: list) -> int:
    for draws in chunk:
        _write_page(out, png_compress, draws)
    return len(chunk)


def write_source(out: str, pages: int = 7672, seed: int = 0, png_compress: int = 3,
                 workers: Optional[int] = None, chunk: int = 8) -> float:
    """Write the tree (see the module doc); returns the seconds taken and
    prints a progress line every 500 pages, as the JAX tool does."""
    os.makedirs(os.path.join(out, "png_json_gt"), exist_ok=True)
    os.makedirs(os.path.join(out, "1x_inpainted_background_png"), exist_ok=True)
    rng = np.random.default_rng(seed)
    workers = workers or os.cpu_count() or 1
    t0 = time.time()
    chunks = []
    for draws in page_draws(rng, pages):  # cheap: no pixels yet
        if not chunks or len(chunks[-1]) == chunk:
            chunks.append([])
        chunks[-1].append(draws)

    done = 0

    def progress(n: int) -> None:
        nonlocal done
        for k in range(done + 1, done + n + 1):
            if k % 500 == 0:
                dt = time.time() - t0
                print(f"{k}/{pages} pages, {dt:.0f}s ({k / dt:.1f} pages/s)", flush=True)
        done += n

    if workers == 1:
        for c in chunks:
            progress(_write_chunk(out, png_compress, c))
    else:
        with ProcessPoolExecutor(max_workers=workers) as pool:
            for n in pool.map(_write_chunk, [out] * len(chunks), [png_compress] * len(chunks),
                              chunks):
                progress(n)
    dt = time.time() - t0
    print(f"done: {pages} pages in {dt:.0f}s -> {out}")
    return dt


def main(argv: Optional[Sequence[str]] = None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--pages", type=int, default=7672)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--png-compress", type=int, default=3,
                    help="source PNG compress_level (3 keeps 7,672 pages to a few GB)")
    ap.add_argument("--workers", type=int, default=None,
                    help="processes that make and encode the pages (default: the host's cores)")
    args = ap.parse_args(argv)
    return write_source(args.out, args.pages, args.seed, args.png_compress, args.workers)


if __name__ == "__main__":
    main()
