"""Build the train and val zips from a tree of ad-banner pages.

    python -m layoutdetr_tpu_torch.dataset_tool --source SRC --dest DEST \
        [--inpaint-aug] [--max-samples N] [--png-compress 0-9]

The port's counterpart of the root ``dataset_tool.py`` (reference
dataset_tool.py:289-366), with argparse in place of click. The source
holds ``png_json_gt/**/<name>.png`` + ``<name>.json`` (a list of elements
with ``label``, ``str`` and ``xyxy_word_fit``) and the inpainted
backgrounds ``1x_inpainted_background_png/**/<name>_inpainted.png`` (or
``3x_...`` with ``--inpaint-aug``). ``DEST/train.zip`` and
``DEST/val.zip`` get ``non_image.json`` ('samples') and, per page,
``<page>_<i>_patch.png`` / ``_patch_orig.png`` / ``_patch_mask.png`` per
element and ``<page>_background_orig.png``. For the same source tree
the zips hold the same entries with the same bytes as the root tool's:

- the 8-label vocabulary (dataset_tool.py:104-113);
- the element validity filter (:135-157): a known label, 0 < len(str) <
  256, the box inside the page, sides <= 1024 px, an aspect that
  survives the 256 resize;
- elements >= 95% inside another are dropped (:160-176);
- pages with 1-9 elements are kept (:180);
- boxes normalised to [xc/W, yc/H, w/W, h/H] (:197-202);
- per element the crop, a 1024^2 centred ``patch_orig`` and its binary
  mask (:210-218);
- the background resized to 1024^2 bilinear (:220-226);
- elements sorted by (top, left) (:74-79); the first 90% of the kept
  pages go to train.zip (:319).

Two passes, as the root tool makes them: the first reads the json and
the PNG headers only and decides the split; the second decodes one page
at a time and streams its images into the zip.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import zipfile
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import PIL.Image

LABEL_LIST = [
    "header", "pre-header", "post-header", "body text",
    "disclaimer / footnote", "button", "callout", "logo",
]
LABEL2INDEX = {label: i for i, label in enumerate(LABEL_LIST)}
MAX_ELEMENTS = 9


def lexicographic_sort_idx(bboxes):
    """Indices that sort boxes by (top, left) (reference dataset_tool.py:74-79)."""
    arr = np.transpose(np.array(bboxes))
    left = arr[0] - arr[2] / 2
    top = arr[1] - arr[3] / 2
    return [i for i, _ in sorted(enumerate(zip(top, left)), key=lambda c: c[1])]


def element_is_valid(element, w_page, h_page) -> bool:
    if "label" not in element or element["label"] not in LABEL_LIST:
        return False
    if "str" not in element or len(element["str"]) == 0 or len(element["str"]) >= 256:
        return False
    x1, y1, x2, y2 = element["xyxy_word_fit"]
    if x1 < 0 or y1 < 0 or w_page < x2 or h_page < y2:
        return False
    if x2 <= x1 or y2 <= y1:
        return False
    width, height = int(x2) - int(x1), int(y2) - int(y1)
    if width > 1024 or height > 1024:
        return False
    if width > height:
        return int(height / width * 256.0) // 2 * 2 != 0
    return int(width / height * 256.0) // 2 * 2 != 0


def drop_covered_elements(elements):
    """The elements whose area is not >= 95% inside another element."""
    kept = []
    for i, e in enumerate(elements):
        x1, y1, x2, y2 = e["xyxy_word_fit"]
        covered = False
        for j, other in enumerate(elements):
            if i == j:
                continue
            ox1, oy1, ox2, oy2 = other["xyxy_word_fit"]
            ix1, iy1 = max(x1, ox1), max(y1, oy1)
            ix2, iy2 = min(x2, ox2), min(y2, oy2)
            if ix1 < ix2 and iy1 < iy2:
                if (ix2 - ix1) * (iy2 - iy1) / ((x2 - x1) * (y2 - y1)) >= 0.95:
                    covered = True
                    break
        if not covered:
            kept.append(e)
    return kept


def page_metadata(json_path: Path) -> Optional[dict]:
    """One page's sample dict, or None when the filter leaves 0 or more
    than 9 elements. Reads the json and the PNG's header only (PIL opens
    lazily). ``xyxy``, the sorted pixel boxes, is for the image pass and
    is not written to non_image.json."""
    w_page, h_page = PIL.Image.open(str(json_path).replace(".json", ".png")).size
    with json_path.open() as f:
        ann = json.load(f)

    elements = drop_covered_elements([e for e in ann if element_is_valid(e, w_page, h_page)])
    if len(elements) == 0 or len(elements) > MAX_ELEMENTS:
        return None

    bboxes, labels, texts, xyxy = [], [], [], []
    for e in elements:
        x1, y1, x2, y2 = e["xyxy_word_fit"]
        bboxes.append([(x1 + x2) / 2.0 / w_page, (y1 + y2) / 2.0 / h_page,
                       (x2 - x1) / w_page, (y2 - y1) / h_page])
        labels.append(LABEL2INDEX[e["label"]])
        texts.append(e["str"])
        xyxy.append([int(x1), int(y1), int(x2), int(y2)])

    order = lexicographic_sort_idx(bboxes)
    attr = {"name": json_path.name, "width": w_page, "height": h_page,
            "num_bbox_labels": len(LABEL_LIST), "filtered": len(ann) != len(elements),
            "has_canvas_element": False}
    return dict(attr=attr, bboxes=[bboxes[i] for i in order], labels=[labels[i] for i in order],
                texts=[texts[i] for i in order], xyxy=[xyxy[i] for i in order], page_label=None)


def page_images(json_path: Path, meta: dict, inpaint_aug: bool) -> dict:
    """One kept page's pixels from one decode: the element crops, their
    1024^2 centred originals and masks, and the 1024^2 background."""
    page = np.array(PIL.Image.open(str(json_path).replace(".json", ".png")))
    if page.ndim == 2:
        page = np.stack([page] * 3, axis=2)
    elif page.shape[2] == 4:
        page = page[:, :, :3]

    patches, patches_orig, patch_masks = [], [], []
    for x1, y1, x2, y2 in meta["xyxy"]:
        crop = page[y1:y2, x1:x2]
        patches.append(crop)
        h, w = y2 - y1, x2 - x1
        rows, cols = slice(512 - h // 2, 512 + h - h // 2), slice(512 - w // 2, 512 + w - w // 2)
        orig = np.zeros((1024, 1024, 3), page.dtype)
        orig[rows, cols] = crop
        patches_orig.append(orig)
        mask = np.zeros((1024, 1024), page.dtype)
        mask[rows, cols] = 255
        patch_masks.append(mask)

    sub = "3x_inpainted_background_png" if inpaint_aug else "1x_inpainted_background_png"
    bg_path = str(json_path).replace("png_json_gt", sub).replace(".json", "_inpainted.png")
    if not os.path.isfile(bg_path):
        raise FileNotFoundError(f"missing background {bg_path}")
    background = np.array(PIL.Image.open(bg_path).resize((1024, 1024),
                                                         resample=PIL.Image.BILINEAR))
    if background.ndim != 3 or background.shape[2] != 3:
        raise ValueError(f"{bg_path}: an RGB background expected, got {background.shape}")
    return dict(patches=patches, patches_orig=patches_orig, patch_masks=patch_masks,
                background_orig=background)


def encode_png(arr: np.ndarray, mode: str = "RGB", compress_level: int = 0) -> bytes:
    buf = io.BytesIO()
    PIL.Image.fromarray(arr, mode).save(buf, format="png", compress_level=compress_level,
                                        optimize=False)
    return buf.getvalue()


def convert_dataset(source: str, dest: str, inpaint_aug: bool = False,
                    max_samples: Optional[int] = None, png_compress: int = 0) -> tuple:
    """Write ``dest/train.zip`` and ``dest/val.zip``; return the numbers
    of train and val samples."""
    json_files = sorted(Path(source).rglob("png_json_gt/**/*.json")) or sorted(
        Path(source).rglob("*.json"))
    if max_samples is not None:
        json_files = json_files[:max_samples]

    processed = [(jf, meta) for jf, meta in ((jf, page_metadata(jf)) for jf in json_files)
                 if meta is not None]
    split = int(len(processed) * 0.90)
    os.makedirs(dest, exist_ok=True)

    metas: tuple = ([], [])
    with zipfile.ZipFile(os.path.join(dest, "train.zip"), "w", zipfile.ZIP_STORED) as zf_train, \
            zipfile.ZipFile(os.path.join(dest, "val.zip"), "w", zipfile.ZIP_STORED) as zf_val:
        for idx, (jf, sample) in enumerate(processed):
            idx_str = f"{idx:08d}"
            archive_fname = f"{idx_str[:5]}/page{idx_str}"
            zf = zf_train if idx < split else zf_val
            metas[idx >= split].append([archive_fname, dict(
                attr=sample["attr"], bboxes=sample["bboxes"], labels=sample["labels"],
                texts=sample["texts"], page_label=sample["page_label"])])
            pix = page_images(jf, sample, inpaint_aug)
            for i, patch in enumerate(pix["patches"]):
                zf.writestr(f"{archive_fname}_{i}_patch.png", encode_png(patch, "RGB", png_compress))
                zf.writestr(f"{archive_fname}_{i}_patch_orig.png",
                            encode_png(pix["patches_orig"][i], "RGB", png_compress))
                zf.writestr(f"{archive_fname}_{i}_patch_mask.png",
                            encode_png(pix["patch_masks"][i], "L", png_compress))
            zf.writestr(f"{archive_fname}_background_orig.png",
                        encode_png(pix["background_orig"], "RGB", png_compress))
        zf_train.writestr("non_image.json", json.dumps({"samples": metas[0]}))
        zf_val.writestr("non_image.json", json.dumps({"samples": metas[1]}))
    return len(metas[0]), len(metas[1])


def _compress_level(text: str) -> int:
    level = int(text)
    if not 0 <= level <= 9:
        raise argparse.ArgumentTypeError(f"{level} is not in 0-9")
    return level


def main(argv: Optional[Sequence[str]] = None) -> tuple:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", required=True, metavar="PATH")
    ap.add_argument("--dest", required=True, metavar="PATH")
    ap.add_argument("--inpaint-aug", action="store_true",
                    help="backgrounds from 3x_inpainted_background_png (else 1x_...)")
    ap.add_argument("--max-samples", type=int, default=None,
                    help="read only the first N pages of the sorted source")
    ap.add_argument("--png-compress", type=_compress_level, default=0,
                    help="PNG compress_level of the zips' images (default 0, the reference's "
                         "uncompressed PNGs; higher trades encode time for much smaller zips, "
                         "the 1024^2 patch planes being mostly zeros). The loaders read either.")
    opts = ap.parse_args(argv)
    n_train, n_val = convert_dataset(opts.source, opts.dest, opts.inpaint_aug, opts.max_samples,
                                     opts.png_compress)
    print(f"Wrote {n_train} train / {n_val} val samples to {opts.dest}")
    return n_train, n_val


if __name__ == "__main__":
    main()
