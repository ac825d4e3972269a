"""Banner rendering: HTML/CSS composition + screenshot, with a pure-PIL fallback.

A copy of ``layoutdetr_tpu/serving/render.py``, so that the port imports
nothing of the JAX package. The PIL path is the one the port runs
(``rendering_val``); ``make_browser`` keeps its lazy, optional selenium
import.

Parity target: generate_util.py:60-290 (visualize_banner and its
adaptive-font helpers) and metrics/rendering_utils.py's Chrome path.

Behavioral parity pieces:
- adaptive font sizing from box geometry + per-type font-to-height
  ratios (get_adaptive_font_size2, generate_util.py:87-96);
- adaptive font/button colors from the median of the background crop
  (generate_util.py:152-172);
- button pill geometry recentering (generate_util.py:221-236);
- HTML text-div composition with identical CSS fields.

Offline path: when selenium+Chrome are absent (GPU hosts usually have
no browser), ``render_banner_pil``
rasterizes the same layout decisions directly with PIL, so the
rendering path works everywhere; the Chrome screenshot path is used
when available for pixel-exact HTML rendering.
"""

from __future__ import annotations

import html
import os
from io import BytesIO
from typing import List, Optional

import numpy as np
import PIL.Image
import PIL.ImageDraw
import PIL.ImageFont

from layoutdetr_tpu_torch.serving.postprocess import convert_xywh_to_ltrb

TEXT_CSS_TEMP = (
    "align-items:center;position:absolute;word-wrap:break-word;"
    "overflow-wrap:break-word;display:flex;"
)

HTML_TEMP = (
    "<html><head></head><body style=\"margin:0px;\"><div style=\"position:relative;\">"
    "<img src=\"\" style=\"position:absolute;top:0px;left:0px;\">"
    "</div></body></html>"
)

FONT2H = {"header": 0.076844, "body": 0.04322475, "button": 0.04082337,
          "disclaimer / footnote": 0.032}


def get_adaptive_font_size(w_tbox, h_tbox, h_page, text, text_type,
                           font_aspect_ratio=0.52, min_font_size=9):
    """(font_size_str, text_width_px) — generate_util.py:87-96."""
    font_size = int(h_page * FONT2H.get(text_type, 0.04322475))
    num_word = max(len(text), 1)
    num_line = num_word * font_size * font_aspect_ratio / max(w_tbox, 1)
    if num_line < 1 or num_line * font_size < h_tbox:
        return str(font_size), int(num_word * font_size * font_aspect_ratio * 1.25)
    shrunk = max(min_font_size, int((w_tbox * h_tbox / num_word / font_aspect_ratio) ** 0.5))
    return str(shrunk), int(num_word * font_size * font_aspect_ratio * 1.25)


def get_adaptive_font_color(img) -> str:
    """Black on bright, white on dark (generate_util.py:152-159)."""
    arr = np.array(img)
    clr = [np.median(arr[:, :, ch]) for ch in range(3)]
    return ("rgba" + str((0, 0, 0, 255))) if sum(clr) > 255 * 3 / 1.5 else ("rgba:" + str((255, 255, 255, 255)))


def get_adaptive_font_button_color(img):
    """(font_color, button_bg_color) (generate_util.py:163-172)."""
    arr = np.array(img)
    clr = [np.median(arr[:, :, ch]) for ch in range(3)]
    if sum(clr) < 255 * 2:
        return "rgba" + str((0, 0, 0, 255)), "rgba" + str((255, 255, 255, 255))
    return "rgba" + str((255, 255, 255, 255)), "rgba" + str((0, 0, 0, 255))


def _element_geometry(box, style, is_center, w_page, h_page):
    """Resolve one element's pixel geometry + font, incl. button pill.

    Also returns ``raw_box``, the pre-pill pixel ltrb: the reference
    resolves the adaptive FONT color from the original box crop before
    the button-pill resize (generate_util.py:206-215 precedes the
    resize at 220-236), while the button BACKGROUND color uses the
    resized crop (generate_util.py:252-255)."""
    x1, y1, x2, y2 = convert_xywh_to_ltrb(box)
    x1, x2 = max(0, int(x1 * w_page)), min(w_page - 1, int(x2 * w_page))
    y1, y2 = max(0, int(y1 * h_page)), min(h_page - 1, int(y2 * h_page))
    # A box off the page or with a negative size (de_overlap can push a box
    # out or shrink it below 0) keeps a 1-pixel extent at its clipped edge:
    # the reference's font sizing takes the square root of a negative area
    # there and fails. Boxes on the page keep their pixels.
    x1, y1 = min(x1, w_page - 1), min(y1, h_page - 1)
    x2, y2 = max(x2, x1), max(y2, y1)
    h_tbox, w_tbox = int(y2 - y1 + 1), int(x2 - x1 + 1)
    raw_box = (int(x1), int(y1), int(x2), int(y2))
    text = style.get("text", "")
    font_size, text_width = get_adaptive_font_size(w_tbox, h_tbox, h_page, text, style["type"])

    if style["type"] == "button":
        r_mar = 1.3
        fs = int(font_size)
        mar = fs / 2 * r_mar
        y_mid = (y1 + y2) / 2
        if is_center:
            x_mid = (x1 + x2) / 2
            y1 = max(0, y_mid - mar - 1)
            y2 = min(h_page - 1, y_mid + mar)
            x1 = max(0, x_mid - text_width / 2 - mar - 1)
            x2 = min(w_page - 1, x_mid + text_width / 2 + mar)
        else:
            y1 = max(0, y_mid - mar - 1)
            y2 = min(h_page - 1, y_mid + mar)
            x2 = min(w_page - 1, x1 + text_width + mar * 2)
        h_tbox, w_tbox = int(y2 - y1 + 1), int(x2 - x1 + 1)
    # No int() cast: after the pill resize the reference's coords are
    # FLOATS and its CSS carries them verbatim ("top:43.9px",
    # generate_util.py:247-248); non-button coords are already ints.
    return x1, y1, x2, y2, w_tbox, h_tbox, font_size, raw_box


def compose_banner_html(boxes, masks, styles: List[dict], is_center: bool,
                        background_img: PIL.Image.Image, img_src: str) -> str:
    """Build the banner HTML string (visualize_banner's DOM construction)."""
    w_page, h_page = background_img.size
    divs = []
    boxes = np.asarray(boxes)[np.asarray(masks)]
    for i in range(boxes.shape[0]):
        if i >= len(styles):
            break
        style = styles[i]
        text = style.get("text", "")
        if not text:
            continue
        x1, y1, x2, y2, w_tbox, h_tbox, font_size, raw_box = _element_geometry(
            boxes[i], style, is_center, w_page, h_page)

        font_color = style.get("style", {}).get("color", "")
        if font_color:
            font_color = f"color:{font_color};"
        else:
            # font color from the PRE-pill crop (generate_util.py:206-215)
            crop = background_img.crop(list(raw_box))
            if style["type"] == "button":
                font_color = f"color:{get_adaptive_font_button_color(crop)[0]};"
            else:
                font_color = f"color:{get_adaptive_font_color(crop)};"
        family = style.get("style", {}).get("fontFamily") or "Arial"

        css = TEXT_CSS_TEMP
        css += ("text-align:center;justify-content:center;"
                if (style["type"] == "button" or is_center) else "text-align:left;")
        css += font_color + f"font-size:{font_size}px;font-family:{family};"
        css += f'id="{style["type"]}";'
        css += f"width:{w_tbox}px;max-width:{w_tbox}px;"
        css += f"height:{h_tbox}px;max-height:{h_tbox}px;"
        css += f"top:{y1}px;left:{x1}px;"
        if style["type"].lower() == "button":
            params = style.get("buttonParams", {})
            # button bg color from the POST-pill crop (generate_util.py:252-255)
            bg = params.get("backgroundColor") or get_adaptive_font_button_color(
                background_img.crop([x1, y1, x2, y2]))[1]
            css += f"background-color:{bg};"
            if params.get("radius"):
                css += f"border-radius:{str(params['radius']).strip()}em;"
        # single-quoted style attr (it embeds the reference's id="..."
        # double-quote quirk) and minimal &/</> text escaping — the same
        # serialization bs4 emits for the reference's saved HTML. User-
        # supplied style values (fontFamily, colors) may themselves
        # contain single quotes or ampersands; entity-escape both
        # (& first, like bs4's attribute serialization) so they can't
        # terminate the attribute early and the unescape round-trip in
        # rerender_html_pil is lossless.
        css_attr = css.replace("&", "&amp;").replace("'", "&#39;")
        divs.append(f"<div style='{css_attr}'>{html.escape(text, quote=False)}</div>")

    doc = HTML_TEMP.replace('src=""', f'src="{img_src}"')
    return doc.replace("</div></body>", "".join(divs) + "</div></body>")


def _parse_rgba(s: str):
    try:
        tup = s[s.index("("):]
        vals = tuple(int(v) for v in tup.strip("()").split(",")[:4])
        return vals
    except Exception:
        return (0, 0, 0, 255)


def render_banner_pil(boxes, masks, styles, is_center, background_img,
                      out_path: str) -> str:
    """Rasterize the banner directly with PIL (no browser needed)."""
    img = background_img.copy().convert("RGB")
    w_page, h_page = img.size
    draw = PIL.ImageDraw.Draw(img, "RGBA")
    boxes = np.asarray(boxes)[np.asarray(masks)]
    for i in range(min(boxes.shape[0], len(styles))):
        style = styles[i]
        text = style.get("text", "")
        if not text:
            continue
        x1, y1, x2, y2, w_tbox, h_tbox, font_size, raw_box = _element_geometry(
            boxes[i], style, is_center, w_page, h_page)
        if style["type"] == "button":
            # font color from the pre-pill crop, pill bg from the resized
            # crop — same resolution order as compose_banner_html.
            fc = get_adaptive_font_button_color(background_img.crop(list(raw_box)))[0]
            bg = get_adaptive_font_button_color(background_img.crop([x1, y1, x2, y2]))[1]
            draw.rounded_rectangle([x1, y1, x2, y2], radius=h_tbox // 2,
                                   fill=_parse_rgba(bg))
            color = _parse_rgba(fc)
        else:
            color = _parse_rgba(get_adaptive_font_color(background_img.crop(list(raw_box))))
        try:
            font = PIL.ImageFont.truetype("DejaVuSans.ttf", int(font_size))
        except Exception:
            font = PIL.ImageFont.load_default()
        tw = draw.textlength(text, font=font)
        tx = x1 + (w_tbox - tw) / 2 if (is_center or style["type"] == "button") else x1
        ty = y1 + (h_tbox - int(font_size)) / 2
        draw.text((tx, ty), text, fill=color, font=font)
    img.save(out_path, format="png")
    return out_path


def rerender_html_pil(html: str, html_dir: str) -> PIL.Image.Image:
    """Re-rasterize a banner from its (possibly user-edited) HTML with
    PIL — the no-browser fallback for the ``/update`` route.

    Only the regular HTML this module's ``compose_banner_html`` emits is
    understood: one base ``<img src>`` plus absolutely-positioned text
    divs with inline px geometry, font-size, rgba color (including the
    reference's ``color:rgba:(...)`` extra-colon quirk for text
    elements, generate_util.py:221) and an optional button
    background-color pill. Edits to texts, positions, sizes, and colors
    round-trip; arbitrary foreign HTML does not (the reference requires
    Chrome for that, api_server.py:226-236).
    """
    import re

    m = re.search(r'<img src=(["\'])([^"\']+)\1', html)
    if not m:
        raise ValueError("no base <img> in banner HTML")
    img = PIL.Image.open(os.path.join(html_dir, m.group(2))).convert("RGB")
    draw = PIL.ImageDraw.Draw(img, "RGBA")

    # compose_banner_html emits single-quoted style attrs (they embed
    # the reference's id="..." double-quote quirk); hand-authored or
    # browser-edited HTML is typically double-quoted — accept both.
    import html as _htmllib

    for dm in re.finditer(r"<div style=(['\"])(.*?)\1>([^<]*)</div>", html):
        # compose_banner_html entity-escapes both the style attr (&#39;)
        # and the text (&amp;/&lt;/&gt;); undo that before drawing so a
        # round-trip rasterizes the original characters.
        style = _htmllib.unescape(dm.group(2))
        text = _htmllib.unescape(dm.group(3))
        if "position:absolute" not in style:
            continue
        if not text.strip():
            continue

        def px(name, default=0):
            pm = re.search(rf"{name}:(-?[0-9.]+)px", style)
            return float(pm.group(1)) if pm else default

        left, top = px("left"), px("top")
        w_tbox = px("width", img.size[0])
        h_tbox = px("height", 20)
        font_size = px("font-size", 16)
        cm = re.search(r"[^-]color:rgba:?\s*(\([^)]*\))", style)
        color = _parse_rgba(cm.group(1)) if cm else (0, 0, 0, 255)
        bm = re.search(r"background-color:rgba:?\s*(\([^)]*\))", style)
        if bm:  # button pill (compose_banner_html button branch)
            draw.rounded_rectangle(
                [left, top, left + w_tbox, top + h_tbox],
                radius=int(h_tbox) // 2, fill=_parse_rgba(bm.group(1)))
        try:
            font = PIL.ImageFont.truetype("DejaVuSans.ttf", int(font_size))
        except Exception:
            font = PIL.ImageFont.load_default()
        tw = draw.textlength(text, font=font)
        tx = left + (w_tbox - tw) / 2
        ty = top + (h_tbox - int(font_size)) / 2
        draw.text((tx, ty), text, fill=color, font=font)
    return img


def make_browser():
    """Headless Chrome webdriver (api_server.py:58-78 semantics)."""
    from selenium import webdriver
    from selenium.webdriver.chrome.options import Options

    options = Options()
    options.add_argument("--headless")
    options.add_argument("--no-sandbox")
    options.add_argument("--disable-dev-shm-usage")
    return webdriver.Chrome(options=options)


def visualize_banner(boxes, masks, styles, is_center, background_img,
                     browser: Optional[object], output_format, generated_file_path: str):
    """Render the banner; Chrome screenshot when a browser is supplied,
    PIL rasterization otherwise. Returns (image_path, html_path)."""
    background_img.save(generated_file_path + ".png")
    doc = compose_banner_html(boxes, masks, styles, is_center, background_img,
                              os.path.basename(generated_file_path + ".png"))
    html_path = generated_file_path + ".html"
    with open(html_path, "w") as f:
        f.write(doc)

    image_path = ""
    if "image" in output_format:
        image_path = generated_file_path + "_vis.png"
        if browser is not None:
            browser.get("file:///" + html_path)
            png = browser.get_screenshot_as_png()
            shot = PIL.Image.open(BytesIO(png))
            shot = shot.crop([0, 0, background_img.size[0], background_img.size[1]])
            shot.save(image_path)
        else:
            render_banner_pil(boxes, masks, styles, is_center, background_img, image_path)
    return image_path, html_path
