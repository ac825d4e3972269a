"""Layout inference: serve requests through the port's Generator.

Counterpart of the JAX package's ``generate.py:32-172``. Each request is
one background and up to 9 (string, label) elements; requests are padded
to 9 elements as there, tokenized, run as one batched forward on the
device and post-processed on the host. Request ``i`` draws its noise and
its post-processing choice from ``seed + i``, so a batch gives each
request what ``generate.py --seed <seed + i>`` gives it alone.

``--ckpt`` takes the three checkpoint forms of
``utils.checkpoint.load_generator_checkpoint``: a training snapshot
(``network-snapshot-*.pt``, its G_ema, config in ``<ckpt>.gcfg.json``), a
``save_generator`` file (a ``torch.save`` of the Generator's
``state_dict``, config in ``<ckpt>.json``) and a reference ``.pkl``
snapshot.

CLI (bbox overlay PNG when PIL is present; no browser rendering):

    python -m layoutdetr_tpu_torch.generate --ckpt g.pt --bg bg.png \
        --strings "Big sale|Shop now" --string-labels "header|button" \
        --outfile out/banner [--device cuda] [--dtype bfloat16]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional, Sequence, Union

import numpy as np
import torch

from layoutdetr_tpu_torch.config import GeneratorConfig
from layoutdetr_tpu_torch.data.dataset import RGB_MEAN, RGB_STD, normalize_image
from layoutdetr_tpu_torch.data.tokenizer import LayoutTokenizer
from layoutdetr_tpu_torch.models.generator import Generator
from layoutdetr_tpu_torch.serving.postprocess import (
    LABEL2INDEX,
    apply_postprocessing,
    jitter,
    save_bboxes_with_background,
)
from layoutdetr_tpu_torch.utils.checkpoint import load_generator_checkpoint as load_generator
from layoutdetr_tpu_torch.utils.profiling import span

MAX_N = 9
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class LayoutRequest:
    background: np.ndarray  # [S, S, 3] ImageNet-normalized float32, S = background_size
    strings: Sequence[str]
    labels: Sequence[Union[str, int]]  # label names (LABEL_LIST) or indices


@dataclasses.dataclass
class Layout:
    bbox: np.ndarray  # [9, 4] (xc, yc, w, h) after jitter and post-processing
    raw: np.ndarray  # [9, 4] the Generator's output
    mask: np.ndarray  # [9] bool, True = a requested element
    labels: np.ndarray  # [9] int
    alignment: bool  # the post-processing's bbox_alignment flag


def preprocess_background(bg_path: str, mode: str):
    """Background preprocessing modes (reference generate.py:251-292).

    Returns (normalized_array [S,S,3] f32, background_orig PIL)."""
    import PIL.Image
    import PIL.ImageFilter

    background_orig = PIL.Image.open(bg_path).convert("RGB")
    w, h = background_orig.size
    if w > h and w > 4096:
        background_orig = background_orig.resize((4096, int(h / w * 4096)), PIL.Image.LANCZOS)
    elif h > w and h > 4096:
        background_orig = background_orig.resize((int(w / h * 4096), 4096), PIL.Image.LANCZOS)

    if mode == "256":
        background = np.array(background_orig.resize((256, 256), PIL.Image.LANCZOS))
    elif mode == "128":
        background = np.array(background_orig.resize((128, 128), PIL.Image.LANCZOS))
    elif mode == "blur":
        bg = background_orig.filter(PIL.ImageFilter.GaussianBlur(radius=3))
        background = np.array(bg.resize((1024, 1024), PIL.Image.LANCZOS))
    elif mode == "jpeg":
        idx = bg_path.rfind("/")
        bg_new = bg_path[:idx] + "_jpeg" + bg_path[idx:].replace(".png", ".jpg")
        background = np.array(PIL.Image.open(bg_new).convert("RGB").resize((1024, 1024), PIL.Image.LANCZOS))
    elif mode == "rec":
        idx = bg_path.rfind("/")
        bg_new = bg_path[:idx] + "_rec" + bg_path[idx:]
        background = np.array(PIL.Image.open(bg_new).convert("RGB").resize((1024, 1024), PIL.Image.LANCZOS))
    elif mode == "edge":
        bg = background_orig.convert("L").filter(PIL.ImageFilter.FIND_EDGES).convert("RGB")
        background = np.array(bg.resize((1024, 1024), PIL.Image.LANCZOS))
    else:
        background = np.array(background_orig.resize((1024, 1024), PIL.Image.LANCZOS))

    if background.ndim == 2:
        background = np.dstack([background] * 3)
    return normalize_image(background[:, :, :3]), background_orig


def resize_background(background: np.ndarray, size: int) -> np.ndarray:
    """Re-sample a normalized background to the model's resolution."""
    import PIL.Image

    if background.shape[0] == size:
        return background
    img = PIL.Image.fromarray(np.uint8(np.clip((background * RGB_STD + RGB_MEAN) * 255, 0, 255)))
    return normalize_image(np.array(img.resize((size, size), PIL.Image.LANCZOS)))


def encode_requests(requests: Sequence[LayoutRequest], cfg: GeneratorConfig,
                    tokenizer: LayoutTokenizer, seed: int) -> dict:
    """Requests -> the Generator's numpy inputs, padded to 9 elements."""
    texts, labels, masks, z = [], [], [], []
    for i, req in enumerate(requests):
        n_real = len(req.strings)
        if n_real != len(req.labels) or not 0 < n_real <= MAX_N:
            raise ValueError(f"request {i}: need 1..{MAX_N} strings with one label each")
        if req.background.shape != (cfg.background_size, cfg.background_size, 3):
            raise ValueError(f"request {i}: background must be "
                             f"[{cfg.background_size}, {cfg.background_size}, 3]")
        texts.append(list(req.strings) + [""] * (MAX_N - n_real))
        idx = [LABEL2INDEX[lab] if isinstance(lab, str) else int(lab) for lab in req.labels]
        labels.append(idx + [0] * (MAX_N - n_real))
        masks.append(np.arange(MAX_N) < n_real)
        z.append(np.random.RandomState(seed + i).randn(MAX_N, cfg.z_dim).astype(np.float32))
    text_ids, text_mask, text_len = tokenizer.encode_layouts(texts)
    return dict(
        z=np.stack(z),
        bbox_class=np.asarray(labels, np.int64),
        text_ids=text_ids, text_mask=text_mask, text_len=text_len,
        padding_mask=~np.stack(masks),
        background=np.stack([np.asarray(r.background, np.float32) for r in requests]),
    )


def generate_layouts(model: Generator, requests: Sequence[LayoutRequest], *, seed: int = 0,
                     device: Union[str, torch.device] = "cuda",
                     tokenizer: Optional[LayoutTokenizer] = None,
                     jitter_strength: float = 0.0, postprocessing: str = "none") -> list:
    """Serve ``requests`` as one batch on ``device`` (where ``model`` lives).

    Returns one ``Layout`` per request. The call runs as five spans in turn
    (``utils.profiling.span``): ``generate.encode``, ``.upload``,
    ``.forward``, ``.download`` and ``.postprocess``."""
    with span("generate.encode"):
        cfg = model.cfg
        if tokenizer is None:
            tokenizer = LayoutTokenizer(max_length=cfg.max_text_length,
                                        length_clip=cfg.text_len_table)
        batch = encode_requests(requests, cfg, tokenizer, seed)
    with span("generate.upload"):
        inputs = {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}
        inputs["text_ids"] = inputs["text_ids"].long()
        inputs["text_len"] = inputs["text_len"].long()
    with torch.inference_mode():
        with span("generate.forward"):
            out = model(bbox_real=None, **inputs)
        with span("generate.download"):
            raw = out.cpu().numpy()

    with span("generate.postprocess"):
        layouts = []
        for i in range(len(requests)):
            mask = ~batch["padding_mask"][i]
            bbox = raw[i:i + 1]
            if jitter_strength > 0.0:
                bbox = jitter(bbox, jitter_strength, seed=0)
            bbox, alignment = apply_postprocessing(bbox, mask[None], postprocessing,
                                                   np.random.RandomState(seed + i))
            layouts.append(Layout(bbox=bbox[0], raw=raw[i], mask=mask,
                                  labels=batch["bbox_class"][i], alignment=alignment))
    return layouts


def save_generator(model: Generator, path: str) -> None:
    """``torch.save`` of the state dict at ``path``, config JSON at ``path.json``."""
    torch.save(model.state_dict(), path)
    with open(path + ".json", "w") as f:
        json.dump(model.cfg.to_dict(), f)


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", required=True,
                    help="a training snapshot (.pt), a save_generator file or a reference .pkl")
    ap.add_argument("--bg", required=True, help="path of a background image")
    ap.add_argument("--bg-preprocessing", default="256",
                    choices=["256", "128", "blur", "jpeg", "rec", "3x_mask", "edge", "none"])
    ap.add_argument("--strings", required=True, help="strings separated by '|'")
    ap.add_argument("--string-labels", required=True, help="labels separated by '|'")
    ap.add_argument("--outfile", required=True)
    ap.add_argument("--out-jittering-strength", type=float, default=0.0)
    ap.add_argument("--out-postprocessing", default="none",
                    choices=["horizontal_center_aligned", "horizontal_left_aligned", "none"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    args = ap.parse_args(argv)
    if not 0.0 <= args.out_jittering_strength <= 1.0:
        ap.error("--out-jittering-strength must lie in [0, 1]")

    model = load_generator(args.ckpt, args.device, DTYPES[args.dtype])
    cfg = model.cfg
    background, background_orig = preprocess_background(args.bg, args.bg_preprocessing)
    background = resize_background(background, cfg.background_size)
    tok = LayoutTokenizer(max_length=cfg.max_text_length, length_clip=cfg.text_len_table)
    tok.require_hf_for_checkpoint(args.ckpt)
    req = LayoutRequest(background, args.strings.split("|"), args.string_labels.split("|"))
    (layout,) = generate_layouts(model, [req], seed=args.seed, device=args.device, tokenizer=tok,
                                 jitter_strength=args.out_jittering_strength,
                                 postprocessing=args.out_postprocessing)

    outfile = os.path.abspath(args.outfile)
    os.makedirs(os.path.dirname(outfile), exist_ok=True)
    save_bboxes_with_background(layout.bbox, layout.mask, layout.labels, background_orig,
                                outfile + "_bboxes.png")
    result = {"strings": list(req.strings), "labels": list(req.labels),
              "bbox_xcycwh": layout.bbox[layout.mask].tolist(), "alignment": layout.alignment}
    with open(outfile + ".json", "w") as f:
        json.dump(result, f)
    print(json.dumps(result))
    return [layout]


if __name__ == "__main__":
    main()
