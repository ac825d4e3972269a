"""The port's HTTP banner server (``layoutdetr_tpu_torch.serving.api_server``)
against the JAX package's (``e2e_pipeline/api_server.py``).

Tiny dims (TINY_KW) with 9 elements and the real vocab, as
``tests/test_serving.py`` serves them; random JAX params crossed over to a
port ``save_generator`` file. ``generate_banners`` on the same image and
elements gives JAX's seed order, overlaps (1e-5) and the boxes it hands to
``visualize_banner`` (1e-5). The four routes answer over a real socket on
127.0.0.1 from a server thread, with 404 for an unknown route and a JSON
500 for a failing request; two predictions load the checkpoint once."""

import base64
import importlib
import io
import json
import os
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import PIL.Image
import pytest
import torch

import jax

from layoutdetr_tpu.data.tokenizer import LayoutTokenizer as JaxTokenizer
from layoutdetr_tpu.models.generator import Generator as JaxGenerator
from layoutdetr_tpu_torch.generate import save_generator
from layoutdetr_tpu_torch.models.generator import Generator
from layoutdetr_tpu_torch.serving import api_server
from layoutdetr_tpu_torch.utils.convert import generator_state_dict_from_jax

from test_torch_common import (
    GENERATE_SPANS,
    REPO_ROOT,
    assert_in_turn,
    load_port,
    profiled_ranges,
    random_params,
    tiny_configs,
)
from test_torch_common import one_torch_thread  # noqa: F401 (module-scoped autouse fixture)

ELEMENTS = [{"text": "Big summer sale", "type": "header"},
            {"text": "Up to 50% off everything in store", "type": "body text"},
            {"text": "Shop now", "type": "button"}]


@pytest.fixture(scope="module")
def jax_api():
    sys.path.insert(0, os.path.join(REPO_ROOT, "e2e_pipeline"))
    try:
        return importlib.import_module("api_server")
    finally:
        sys.path.remove(os.path.join(REPO_ROOT, "e2e_pipeline"))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory, jax_api):
    """A port save_generator file of crossed-over tiny JAX weights; the
    same weights in the JAX server's model cache under the same name."""
    jcfg, cfg = tiny_configs(vocab_size=30524, bos_token_id=30522)
    rng = np.random.default_rng(0)
    n, t, s = jcfg.max_elements, jcfg.max_text_length, jcfg.background_size
    kw = dict(z=np.zeros((1, n, 4), np.float32), bbox_class=np.zeros((1, n), np.int64),
              bbox_real=np.zeros((1, n, 4), np.float32),
              text_ids=rng.integers(1, 60, size=(1, n, t)), text_mask=np.ones((1, n, t), np.int32),
              text_len=np.zeros((1, n), np.int64), padding_mask=np.zeros((1, n), bool),
              background=np.zeros((1, s, s, 3), np.float32))
    g = JaxGenerator(jcfg)
    params = random_params(g, reconst=True, **kw)
    path = str(tmp_path_factory.mktemp("ckpt") / "g.pt")
    save_generator(load_port(Generator(cfg), generator_state_dict_from_jax(params, cfg)), path)
    tok = JaxTokenizer(max_length=jcfg.max_text_length, length_clip=jcfg.text_len_table)
    jax_api._MODEL_CACHE[path] = (g, jax.jit(g.apply), {"params": params}, jcfg, tok)
    yield path
    jax_api._MODEL_CACHE.pop(path, None)
    api_server._MODEL_CACHE.clear()


def _recorded(monkeypatch, module, name: str, seen: list):
    """Record the boxes, alignment and seed of each visualize_banner call."""
    real = getattr(module, name)

    def record(boxes, masks, styles, is_center, background_img, browser, fmt, path):
        seen.append((int(path.rsplit("_", 1)[1]), np.array(boxes), bool(is_center)))
        return real(boxes, masks, styles, is_center, background_img, browser, fmt, path)

    monkeypatch.setattr(module, name, record)


def _background():
    rng = np.random.default_rng(1)
    return PIL.Image.fromarray(rng.integers(0, 255, size=(48, 96, 3), dtype=np.uint8))


def test_generate_banners_matches_jax(ckpt, jax_api, tmp_path, monkeypatch):
    import layoutdetr_tpu.serving.render as jax_render

    got_boxes, want_boxes = [], []
    _recorded(monkeypatch, api_server, "visualize_banner", got_boxes)
    _recorded(monkeypatch, jax_render, "visualize_banner", want_boxes)
    bg = _background()
    want = jax_api.generate_banners(ckpt, bg, ELEMENTS, 3, output_dir=str(tmp_path / "jax"))
    got = api_server.generate_banners(ckpt, bg, ELEMENTS, 3, output_dir=str(tmp_path / "port"),
                                      device="cpu")
    assert [r["seed"] for r in got] == [r["seed"] for r in want]
    assert sorted(r["seed"] for r in got) == [1, 2, 3]
    overlaps = [r["overlap"] for r in got]
    assert overlaps == sorted(overlaps)
    np.testing.assert_allclose(overlaps, [r["overlap"] for r in want], rtol=0, atol=1e-5)
    assert len(got_boxes) == len(want_boxes) == 3 and max(overlaps) > 0
    assert [(s, c) for s, _, c in got_boxes] == [(s, c) for s, _, c in want_boxes]
    for (_, g, _), (_, w, _) in zip(got_boxes, want_boxes):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    for r in got:
        assert os.path.exists(r["image"]) and os.path.exists(r["html"])


def test_generate_banners_runs_in_the_entry_spans(ckpt, tmp_path):
    """Profiled, the server's path shows the serving entry's five spans once
    each, in turn."""
    got, ranges = profiled_ranges(
        lambda: api_server.generate_banners(ckpt, _background(), ELEMENTS, 2,
                                            output_dir=str(tmp_path), device="cpu"),
        "generate.")
    assert len(got) == 2
    assert_in_turn(ranges, GENERATE_SPANS)


def _request(url: str, body=None):
    """(status, parsed JSON or None) of a GET (body None) or a JSON POST."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        payload = e.read()
        ctype = e.headers.get("Content-Type", "")
        return e.code, json.loads(payload) if ctype == "application/json" else None


@pytest.fixture
def server(ckpt, tmp_path, monkeypatch):
    loads = []
    real = api_server.load_generator_checkpoint

    def counted(*a, **k):
        loads.append(a[0])
        return real(*a, **k)

    monkeypatch.setattr(api_server, "load_generator_checkpoint", counted)
    api_server._MODEL_CACHE.clear()
    cfg = api_server.ServerConfig(ckpt, "cpu", torch.float32, upload_dir=str(tmp_path / "up"),
                                  generated_dir=str(tmp_path / "gen"))
    srv = api_server.make_server(cfg, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}", cfg, loads
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
        assert not thread.is_alive()


def test_routes_over_a_socket(server):
    url, cfg, loads = server
    buf = io.BytesIO()
    _background().save(buf, "PNG")
    status, up = _request(url + "/upload", {"image": base64.b64encode(buf.getvalue()).decode()})
    assert status == 200 and os.path.exists(os.path.join(cfg.upload_dir, up["imageId"]))

    body = {"imageId": up["imageId"], "numResults": 2, "contentStyle": {"elements": ELEMENTS}}
    status, pred = _request(url + "/prediction", body)
    assert status == 200 and len(pred["results"]) == 2
    # a client's imageId is reduced to its basename
    status, pred2 = _request(url + "/prediction", dict(body, imageId="../../x/" + up["imageId"]))
    seeds = [r["seed"] for r in pred["results"]]
    assert status == 200 and [r["seed"] for r in pred2["results"]] == seeds
    assert loads == [cfg.ckpt]  # two predictions, one load
    for r in pred["results"] + pred2["results"]:
        assert os.path.exists(r["image"]) and os.path.exists(r["html"])

    html = pred["results"][0]["html"]
    with open(html) as f:
        doc = f.read()
    status, upd = _request(url + "/update", {"editedHTMLs": [
        {"htmlName": os.path.basename(html), "htmlContent": doc.replace("Shop now", "Buy")}]})
    assert status == 200 and upd["updatedStatus"][0]["status"] == "success"
    assert os.path.exists(html[:-len(".html")] + "_vis.png")

    assert _request(url + "/save") == (200, {"status": "success"})
    assert _request(url + "/save", {}) == (200, {"status": "success"})
    assert _request(url + "/nope", {})[0] == 404
    assert _request(url + "/nope")[0] == 404

    status, err = _request(url + "/prediction", dict(body, imageId="missing.png"))
    assert status == 500 and "FileNotFoundError" in err["error"]
    status, err = _request(url + "/prediction", dict(body, contentStyle={"elements": []}))
    assert status == 500 and "1..9 elements" in err["error"]


def test_main_refuses_cuda_without_a_card(ckpt):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit):
        api_server.main(["--ckpt", ckpt])


def test_a_box_off_the_page_still_renders(tmp_path):
    """de_overlap can push a box off the page or shrink its height below 0;
    such an element keeps a 1-pixel extent at its clipped edge, where the
    JAX package's renderer raises on each of these boxes (its font sizing
    takes the square root of a negative area, its crop gets lower < upper):
    the difference by design of ROADMAP Queue C."""
    from layoutdetr_tpu.serving.render import visualize_banner as jax_visualize_banner
    from layoutdetr_tpu_torch.serving.render import visualize_banner

    boxes = np.array([[0.5, -0.2, 0.4, 0.1], [0.5, 0.5, 0.6, -0.05], [0.5, 1.3, 0.3, 0.1],
                      [1.4, 0.5, 0.2, 0.1]], np.float32)
    elements = ELEMENTS + [{"text": "logo", "type": "logo"}]
    for i in range(len(boxes)):
        with pytest.raises((ValueError, TypeError)):
            jax_visualize_banner(boxes[i:i + 1], np.ones(1, bool), elements[i:i + 1], True,
                                 _background(), None, ["image", "html"],
                                 str(tmp_path / f"jax_{i}"))
    image, html = visualize_banner(boxes, np.ones(4, bool), elements, True, _background(), None,
                                   ["image", "html"], str(tmp_path / "banner"))
    assert os.path.exists(image) and os.path.exists(html)
    with open(html) as f:
        doc = f.read()
    assert doc.count(";height:1px;") == 2 and doc.count(";width:1px;") == 1


@pytest.mark.parametrize("kind", ["header", "button"])
def test_an_off_page_box_takes_its_font_colour_from_the_page(tmp_path, kind):
    """The colour crops of a box the render clamps to its clipped edge take
    the one pixel column the box keeps and follow the page, with no empty-slice
    warning. A crop of 0 pixels has a NaN median, which read as a dark page
    for a text and as a bright one for a button, whatever the page."""
    import warnings

    from layoutdetr_tpu_torch.serving.render import (_element_geometry, compose_banner_html,
                                                     render_banner_pil)

    box = np.array([[1.2, 0.5, 0.2, 0.2]], np.float32)
    style = {"text": "Hello", "type": kind}
    font_crop, pill_crop = _element_geometry(box[0], style, False, 200, 100)[-1]
    assert font_crop[2] - font_crop[0] == 1 and pill_crop[2] - pill_crop[0] == 1
    black, white = "(0, 0, 0, 255)", "(255, 255, 255, 255)"
    # a text is dark on a bright page; a button is a dark pill with a
    # white font there (get_adaptive_font_button_color), the other way on
    # a dark page
    cases = ((250, black, None), (5, white, None)) if kind == "header" else \
        ((250, white, black), (5, black, white))
    for shade, font, pill in cases:
        page = PIL.Image.new("RGB", (200, 100), (shade,) * 3)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            doc = compose_banner_html(box, np.ones(1, bool), [style], False, page, "bg.png")
            render_banner_pil(box, np.ones(1, bool), [style], False, page,
                              str(tmp_path / f"{kind}_{shade}.png"))
        # the reference writes a text's white as "rgba:(...)" (render.py)
        assert f"color:rgba{':' if kind == 'header' and font == white else ''}{font};" in doc
        if kind == "button":
            assert f"background-color:rgba{pill};" in doc


def test_an_on_page_box_keeps_the_reference_colour_crops():
    """On the page the crops are the reference's: the pre-pill box as
    truncated, the pill as resized, nothing added."""
    from layoutdetr_tpu_torch.serving.render import _element_geometry

    for kind in ("header", "button"):
        x1, y1, x2, y2, *_, (font_crop, pill_crop) = _element_geometry(
            np.array([0.5, 0.5, 0.3, 0.2]), {"text": "Hi", "type": kind}, False, 200, 100)
        assert font_crop == (70, 40, 130, 60)
        assert pill_crop == [x1, y1, x2, y2]
