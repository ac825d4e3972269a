"""HTTP banner server: a background and its texts in, ranked banners out.

Counterpart of ``e2e_pipeline/api_server.py`` (reference
e2e_pipeline/api_server.py: ``/upload`` :85-109, ``/prediction``
:112-185, ``/update`` :188-245, ``/save`` :248+):

- ``load_model``: the Generator of a ``--ckpt`` (the three forms of
  ``utils.checkpoint.load_generator_checkpoint``) on the serving device,
  with its tokenizer, loaded once per (checkpoint, device, dtype);
- ``generate_banners``: one batched forward for ``numResults`` seeds
  through ``generate.generate_layouts`` (seeds 1..numResults, z of seed s
  from ``RandomState(s).randn(9, z_dim)``, so that on the same weights the
  boxes are the JAX server's) under ``torch.inference_mode()``, where the
  text encoder runs the fused attention kernel; then per seed, from the seed's ``RandomState``, jitter
  (probability 5/6) and center alignment (2/3), the overlap metric, a
  ranking by overlap and a banner rendered as an image and an HTML page;
- the four handlers and ``ROUTES``, served by the stdlib ``http.server``
  (``make_server`` binds, ``serve_forever`` runs it, so a caller can serve
  from a thread). The JAX server's Flask front is not ported: the stdlib
  server is its fallback there and the only front here.

One difference by design: a client's ``imageId`` is reduced to its
basename before it is joined to the upload directory, as ``/update``
does with ``htmlName``; the JAX server's ``os.path.join(UPLOAD_DIR,
image_id)`` reads any path a client names. ``imagePath`` keeps its
meaning (a path on the server's host).

    python -m layoutdetr_tpu_torch.serving.api_server --ckpt g.pt \\
        [--device cuda] [--dtype float32] [--host 0.0.0.0] [--port 5000]

``--ckpt`` defaults to ``$LAYOUTDETR_CKPT``.
"""

from __future__ import annotations

import argparse
import base64
import dataclasses
import io
import json
import os
import tempfile
import traceback
import uuid
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import PIL.Image
import torch

from layoutdetr_tpu_torch.data.dataset import normalize_image
from layoutdetr_tpu_torch.data.tokenizer import LayoutTokenizer
from layoutdetr_tpu_torch.generate import DTYPES, MAX_N, LayoutRequest, generate_layouts
from layoutdetr_tpu_torch.metrics.layout_metrics import compute_overlap
from layoutdetr_tpu_torch.serving.postprocess import LABEL2INDEX, apply_postprocessing, jitter
from layoutdetr_tpu_torch.serving.render import make_browser, rerender_html_pil, visualize_banner
from layoutdetr_tpu_torch.utils.checkpoint import load_generator_checkpoint

THUMB = (600, 400)  # /update's thumbnail resolution (api_server.py:198)

# (checkpoint, device, dtype) -> (Generator on the device, its tokenizer)
_MODEL_CACHE: Dict[Tuple[str, str, torch.dtype], tuple] = {}


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """What the handlers serve: the checkpoint, where its model runs, and
    the directories uploads and generated banners go to."""

    ckpt: str
    device: str = "cuda"
    dtype: torch.dtype = torch.float32
    upload_dir: str = os.path.join(tempfile.gettempdir(), "layoutdetr_uploads")
    generated_dir: str = os.path.join(tempfile.gettempdir(), "layoutdetr_generated")


def load_model(ckpt: str, device: str = "cuda", dtype: torch.dtype = torch.float32):
    """(Generator, tokenizer) of ``ckpt`` on ``device``, loaded on the first
    call and cached (reference generate_util.py:344-351)."""
    key = (ckpt, str(device), dtype)
    if key not in _MODEL_CACHE:
        model = load_generator_checkpoint(ckpt, device, dtype)
        cfg = model.cfg
        tok = LayoutTokenizer(max_length=cfg.max_text_length, length_clip=cfg.text_len_table)
        tok.require_hf_for_checkpoint(ckpt)
        _MODEL_CACHE[key] = (model, tok)
    return _MODEL_CACHE[key]


def generate_banners(ckpt: str, background_img: PIL.Image.Image, elements, num_results: int = 5,
                     output_dir: Optional[str] = None, seed_base: int = 1, device: str = "cuda",
                     dtype: torch.dtype = torch.float32) -> list:
    """Seeds ``seed_base..seed_base+num_results-1`` in one forward, post-
    processed, ranked by overlap (ascending) and rendered (reference
    generate_util.py:353-463). Returns one dict per banner: ``seed``,
    ``overlap``, ``image`` and ``html`` paths. The forward is
    ``generate.generate_layouts`` over the page ``num_results`` times from
    ``seed_base`` (layout i's noise from ``RandomState(seed_base + i)``), so
    a profile shows its spans ``generate.encode``, ``.upload``, ``.forward``,
    ``.download`` and ``.postprocess``."""
    model, tok = load_model(ckpt, device, dtype)
    size = model.cfg.background_size
    output_dir = output_dir or tempfile.mkdtemp(prefix="banners_")
    os.makedirs(output_dir, exist_ok=True)
    if not 0 < len(elements) <= MAX_N:
        raise ValueError(f"need 1..{MAX_N} elements, got {len(elements)}")
    request = LayoutRequest(
        background=normalize_image(np.array(background_img.resize((size, size), PIL.Image.LANCZOS))),
        strings=[e.get("text", "") for e in elements],
        labels=[LABEL2INDEX.get(e.get("type", "body text"), 3) for e in elements])
    layouts = generate_layouts(model, [request] * num_results, seed=seed_base, device=device,
                               tokenizer=tok)

    variants = []
    for seed, layout in zip(range(seed_base, seed_base + num_results), layouts):
        rng = np.random.RandomState(seed)
        bbox, mask = layout.raw[None], layout.mask
        if rng.random_sample() < 5 / 6:  # api_server.py:165-168
            bbox = jitter(bbox, 0.2, seed)
        mode = "horizontal_center_aligned" if rng.random_sample() < 2 / 3 else "none"
        bbox, is_center = apply_postprocessing(bbox, mask[None], mode, rng)
        overlap = float(compute_overlap(torch.from_numpy(bbox), torch.from_numpy(mask[None]))[0])
        variants.append((overlap, seed, bbox, is_center))

    variants.sort(key=lambda v: v[0])  # rank by overlap (generate_util.py:442-451)
    results = []
    for overlap, seed, bbox, is_center in variants:
        stem = os.path.join(output_dir, f"banner_{uuid.uuid4().hex[:8]}_{seed}")
        image_path, html_path = visualize_banner(bbox[0], mask, elements, is_center,
                                                 background_img, None, ["image", "html"], stem)
        results.append(dict(seed=seed, overlap=overlap, image=image_path, html=html_path))
    return results


def handle_upload(cfg: ServerConfig, body: dict) -> dict:
    """{"image": base64 PNG} -> {"imageId"}."""
    os.makedirs(cfg.upload_dir, exist_ok=True)
    name = f"{uuid.uuid4().hex}.png"
    with open(os.path.join(cfg.upload_dir, name), "wb") as f:
        f.write(base64.b64decode(body["image"]))
    return {"imageId": name}


def handle_prediction(cfg: ServerConfig, body: dict) -> dict:
    """{"imageId" | "imagePath", "contentStyle": {"elements": [{"text",
    "type", "style"}]}, "numResults"} -> {"results": [...]}, best first."""
    image_id = body.get("imageId")
    path = (os.path.join(cfg.upload_dir, os.path.basename(image_id)) if image_id
            else body["imagePath"])
    background = PIL.Image.open(path).convert("RGB")
    elements = body.get("contentStyle", {}).get("elements", [])
    results = generate_banners(cfg.ckpt, background, elements, int(body.get("numResults", 5)),
                               output_dir=cfg.generated_dir, device=cfg.device, dtype=cfg.dtype)
    return {"results": results}


def handle_update(cfg: ServerConfig, body: dict) -> dict:
    """Save edited HTMLs and re-screenshot each (reference
    api_server.py:188-245): {"editedHTMLs": [{"htmlName", "htmlContent"}]}
    -> {"updatedStatus": [{"htmlName", "status"}]}. The screenshot is
    cropped to the banner and thumbnailed to 600x400 as ``<name>_vis.png``;
    without selenium and Chrome the HTML is re-rasterized with PIL."""
    os.makedirs(cfg.generated_dir, exist_ok=True)
    updated = []
    for item in body["editedHTMLs"]:
        html_name = item["htmlName"]
        status = "success"
        try:
            html_path = os.path.join(cfg.generated_dir, os.path.basename(html_name))
            with open(html_path, "w") as f:
                f.write(item["htmlContent"])
            stem, _ = os.path.splitext(html_path)
            w_page, h_page = PIL.Image.open(stem + ".png").size
            try:
                browser = make_browser()
            except Exception:  # no selenium or no Chrome on this host
                browser = None
            if browser is not None:
                browser.get("file:///" + html_path)
                shot = PIL.Image.open(io.BytesIO(browser.get_screenshot_as_png()))
            else:
                shot = rerender_html_pil(item["htmlContent"], os.path.dirname(html_path))
            shot = shot.crop([0, 0, w_page, h_page])
            if w_page > THUMB[0] or h_page > THUMB[1]:
                shot.thumbnail(THUMB, PIL.Image.LANCZOS)
            shot.save(stem + "_vis.png")
        except Exception:  # one bad page does not fail the others
            traceback.print_exc()
            status = "error"
        updated.append({"htmlName": html_name, "status": status})
    return {"updatedStatus": updated}


def handle_save(cfg: ServerConfig, body: dict) -> dict:
    """A stub (reference api_server.py:248-253)."""
    del cfg, body
    return {"status": "success"}


ROUTES: Dict[str, Callable[[ServerConfig, dict], dict]] = {
    "/upload": handle_upload,
    "/prediction": handle_prediction,
    "/update": handle_update,
    "/save": handle_save,
}


def make_server(cfg: ServerConfig, host: str = "127.0.0.1", port: int = 0) -> HTTPServer:
    """The routes on the stdlib ``http.server``, bound to (host, port) but
    not yet serving (``serve_forever``); port 0 picks a free one
    (``server.server_address``). A handler's exception answers 500 with
    {"error": ...}; an unknown route answers 404."""

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict) -> None:
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/save":  # /save takes GET too (api_server.py:248)
                self._reply(200, handle_save(cfg, {}))
            else:
                self.send_error(404)

        def do_POST(self):
            # the body is read before any answer: a socket closed with unread
            # request bytes resets, and the client may lose the 404
            raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            handler = ROUTES.get(self.path)
            if handler is None:
                self.send_error(404)
                return
            try:
                body = json.loads(raw or b"{}")
                self._reply(200, handler(cfg, body))
            except Exception as e:  # the client gets the error as JSON
                traceback.print_exc()
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return HTTPServer((host, port), Handler)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", default=os.environ.get("LAYOUTDETR_CKPT"),
                    help="a save_generator file, a training snapshot or a reference .pkl "
                         "(default $LAYOUTDETR_CKPT)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=5000)
    args = ap.parse_args(argv)
    if not args.ckpt:
        ap.error("--ckpt (or LAYOUTDETR_CKPT) is required")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        ap.error("no CUDA device; pass --device cpu to serve on the CPU")
    cfg = ServerConfig(args.ckpt, args.device, DTYPES[args.dtype])
    load_model(cfg.ckpt, cfg.device, cfg.dtype)  # fail before serving, not on the first request
    server = make_server(cfg, args.host, args.port)
    print(f"Serving on {args.host}:{server.server_address[1]} (stdlib http.server)", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
