"""Real-patch layout compositing for the image FID.

A copy of ``layoutdetr_tpu/metrics/compositing.py``, so that the port
imports nothing of the JAX package. Parity target util.py:234-325
(``convert_layout_to_real_image_with_background``): the real cropped
element patches (center-cropped from ``patch_orig`` at their real pixel
size) are pasted onto the original background at the generated box
positions, largest boxes first, then the page is resized to a square
canvas. Host-side numpy and PIL, as in the reference; PIL's bilinear
resize stands in for skimage's anti-aliased one.
"""

from __future__ import annotations

import numpy as np
import PIL.Image

from layoutdetr_tpu_torch.data.dataset import denormalize_image as _denorm_uint8
from layoutdetr_tpu_torch.serving.postprocess import convert_xywh_to_ltrb


def _resize(img_u8: np.ndarray, h: int, w: int) -> np.ndarray:
    return np.asarray(PIL.Image.fromarray(img_u8).resize((max(w, 1), max(h, 1)), PIL.Image.BILINEAR))


def _expand2square(img: PIL.Image.Image) -> PIL.Image.Image:
    """Pad to a square with black, centered (util.py:71-82)."""
    w, h = img.size
    if w == h:
        return img
    side = max(w, h)
    out = PIL.Image.new("RGB", (side, side), (0, 0, 0))
    out.paste(img, ((side - w) // 2, (side - h) // 2))
    return out


def composite_layout(boxes_fake, boxes_real, patches_orig, bg_orig,
                     W_page: int, H_page: int, size_canvas: int = 1024) -> np.ndarray:
    """One layout -> uint8 [size_canvas, size_canvas, 3].

    boxes_fake/boxes_real: [M, 4] cxcywh in [0,1] (valid elements only);
    patches_orig: [M, Hp, Wp, 3] ImageNet-normalized float;
    bg_orig: [Hb, Wb, 3] ImageNet-normalized float (util.py:233-296)."""
    W_page, H_page = int(W_page), int(H_page)
    img = _resize(_denorm_uint8(np.asarray(bg_orig)), H_page, W_page).astype(np.float32)

    # largest generated boxes first, so small elements stay on top (util.py:241-246)
    area = [float(b[2]) * float(b[3]) for b in boxes_fake]
    for i in sorted(range(len(area)), key=lambda k: area[k], reverse=True):
        bf, br, patch = boxes_fake[i], boxes_real[i], np.asarray(patches_orig[i])
        width = int(float(br[2]) * W_page)
        height = int(float(br[3]) * H_page)
        cy, cx = patch.shape[0] // 2, patch.shape[1] // 2
        # center crop at the element's real pixel size (util.py:251-255)
        h0, h1 = cy - height // 2, cy + height - height // 2
        w0, w1 = cx - width // 2, cx + width - width // 2
        im = _denorm_uint8(patch[max(h0, 0):max(h1, h0 + 1), max(w0, 0):max(w1, w0 + 1)])

        x1, y1, x2, y2 = convert_xywh_to_ltrb(np.asarray(bf, np.float64))
        x1, x2 = int(round(x1 * W_page)), int(round(x2 * W_page))
        y1, y2 = int(round(y1 * H_page)), int(round(y2 * H_page))
        im = _resize(im, max(y2 - y1, 1), max(x2 - x1, 1)).astype(np.float32)

        # clip the overhang (util.py:263-282)
        if y1 < 0:
            im = im[-y1:]
            y1 = 0
        if y2 > H_page:
            im = im[: im.shape[0] - (y2 - H_page)]
            y2 = H_page
        if x1 < 0:
            im = im[:, -x1:]
            x1 = 0
        if x2 > W_page:
            im = im[:, : im.shape[1] - (x2 - W_page)]
            x2 = W_page
        if y2 > y1 and x2 > x1 and im.size:
            img[y1:y2, x1:x2] = im[: y2 - y1, : x2 - x1]

    # longest side to size_canvas (even short side), square pad (util.py:285-296)
    pil = PIL.Image.fromarray(img.astype(np.uint8), "RGB")
    if W_page > H_page:
        w_new, h_new = size_canvas, int(H_page / W_page * size_canvas) // 2 * 2
    else:
        h_new, w_new = size_canvas, int(W_page / H_page * size_canvas) // 2 * 2
    pil = pil.resize((max(w_new, 2), max(h_new, 2)), resample=PIL.Image.BILINEAR)
    return np.asarray(_expand2square(pil))


def composite_batch(bbox_fake, bbox_real, patches_orig, mask, background_orig,
                    W_page, H_page, size_canvas: int = 1024) -> np.ndarray:
    """Batch wrapper (util.py:299-325): uint8 [B, size_canvas, size_canvas, 3]."""
    out = []
    for i in range(np.asarray(bbox_fake).shape[0]):
        m = np.asarray(mask[i], bool)
        out.append(composite_layout(
            np.asarray(bbox_fake[i])[m], np.asarray(bbox_real[i])[m],
            np.asarray(patches_orig[i])[m], np.asarray(background_orig[i]),
            int(W_page[i]), int(H_page[i]), size_canvas))
    return np.stack(out)
