"""Layout geometry losses and metrics.

Counterpart of ``layoutdetr_tpu/metrics/layout_metrics.py`` (reference
metrics/metric_layoutnet.py:66-275, util.py convert_xywh_to_ltrb). The
torch functions are the loss math of the GAN step; every one takes a
fixed ``[B, N]`` validity mask and reduces over static shapes, as the JAX
ones do. The evaluation suite also runs ``compute_overlap`` and
``compute_alignment`` on float64 CPU tensors. ``compute_iou`` and
``compute_docsim_weight`` take paired boxes [N, 4] in numpy: the host path
the evaluation suite uses (JAX's ``xp=np``).

- ``bbox``: ``[..., 4]`` as ``[xc, yc, w, h]`` normalized to [0, 1].
- ``mask``: bool, True = **valid** element.
"""

from __future__ import annotations

import numpy as np
import torch


def convert_xywh_to_ltrb(bbox):
    """[xc, yc, w, h] (stacked on dim 0) -> (l, t, r, b). Mirrors util.py:25-31."""
    xc, yc, w, h = bbox[0], bbox[1], bbox[2], bbox[3]
    return xc - w / 2, yc - h / 2, xc + w / 2, yc + h / 2


def _safe_div(a, b):
    """a / b with 0 where the quotient is non-finite (torch.nan_to_num parity)."""
    return torch.nan_to_num(a / b, nan=0.0, posinf=0.0, neginf=0.0)


def compute_overlap(bbox, mask):
    """[B] mean pairwise (intersection / own-area) per valid element
    (metric_layoutnet.py:153-179)."""
    bbox = torch.where(mask[..., None], bbox, 0.0)
    bbox = bbox.movedim(-1, 0)  # [4, B, N]

    l1, t1, r1, b1 = convert_xywh_to_ltrb(bbox[..., None])  # [B, N, 1]
    l2, t2, r2, b2 = convert_xywh_to_ltrb(bbox[:, :, None, :])  # [B, 1, N]
    a1 = (r1 - l1) * (b1 - t1)

    l_max = torch.maximum(l1, l2)
    r_min = torch.minimum(r1, r2)
    t_max = torch.maximum(t1, t2)
    b_min = torch.minimum(b1, b2)
    cond = (l_max < r_min) & (t_max < b_min)
    ai = torch.where(cond, (r_min - l_max) * (b_min - t_max), 0.0)  # [B, N, N]

    n = ai.shape[-1]
    diag = torch.eye(n, dtype=torch.bool, device=ai.device)
    ai = torch.where(diag[None], 0.0, ai)

    ar = _safe_div(ai, a1)
    return ar.sum(dim=(1, 2)) / mask.to(bbox.dtype).sum(-1)


def compute_alignment(bbox, mask):
    """[B] alignment loss (metric_layoutnet.py:182-201), with its quirks:
    padded columns are not masked (only rows), the diagonal is 1, and an
    exact-1 minimum is zeroed before the -log."""
    bb = bbox.movedim(-1, 0)  # [4, B, N]
    xl, yt, xr, yb = convert_xywh_to_ltrb(bb)
    xc, yc = bb[0], bb[1]
    x = torch.stack([xl, xc, xr, yt, yc, yb], dim=1)  # [B, 6, N]

    x = x[..., None] - x[..., None, :]  # [B, 6, N, N]
    n = x.shape[-1]
    diag = torch.eye(n, dtype=torch.bool, device=x.device)
    x = torch.where(diag[None, None], 1.0, x)
    x = x.abs().transpose(1, 2)  # [B, N, 6, N]
    x = torch.where(mask[:, :, None, None], x, 1.0)
    x = x.amin(dim=-1).amin(dim=-1)  # [B, N]
    x = torch.where(x == 1.0, 0.0, x)

    x = -torch.log1p(-x)
    return x.sum(-1) / mask.to(x.dtype).sum(-1)


def generalized_iou_loss(bbox_pred, bbox_tgt, mask=None):
    """Masked mean of (1 - GIoU) over valid elements (metric_layoutnet.py:245-275)."""
    l1, t1, r1, b1 = convert_xywh_to_ltrb(bbox_pred.movedim(-1, 0))
    l2, t2, r2, b2 = convert_xywh_to_ltrb(bbox_tgt.movedim(-1, 0))
    a1, a2 = (r1 - l1) * (b1 - t1), (r2 - l2) * (b2 - t2)

    l_max = torch.maximum(l1, l2)
    r_min = torch.minimum(r1, r2)
    t_max = torch.maximum(t1, t2)
    b_min = torch.minimum(b1, b2)
    cond = (l_max < r_min) & (t_max < b_min)
    ai = torch.where(cond, (r_min - l_max) * (b_min - t_max), 0.0)

    au = a1 + a2 - ai
    iou = ai / au

    l_min = torch.minimum(l1, l2)
    r_max = torch.maximum(r1, r2)
    t_min = torch.minimum(t1, t2)
    b_max = torch.maximum(b1, b2)
    ah = (r_max - l_min) * (b_max - t_min)

    per_elem = 1.0 - (iou - (ah - au) / ah)
    if mask is None:
        return per_elem.mean()
    m = mask.to(per_elem.dtype)
    return torch.where(mask, per_elem, 0.0).sum() / m.sum().clamp(min=1.0)


def compute_iou(box_1: np.ndarray, box_2: np.ndarray) -> np.ndarray:
    """Elementwise IoU of paired boxes [N, 4] on the host, numpy
    (metric_layoutnet.py:66-92; JAX ``compute_iou(..., xp=np)``)."""
    l1, t1, r1, b1 = convert_xywh_to_ltrb(box_1.T)
    l2, t2, r2, b2 = convert_xywh_to_ltrb(box_2.T)
    a1, a2 = (r1 - l1) * (b1 - t1), (r2 - l2) * (b2 - t2)

    l_max = np.maximum(l1, l2)
    r_min = np.minimum(r1, r2)
    t_max = np.maximum(t1, t2)
    b_min = np.minimum(b1, b2)
    cond = (l_max < r_min) & (t_max < b_min)
    ai = np.where(cond, (r_min - l_max) * (b_min - t_max), 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = ai / (a1 + a2 - ai)
    return np.nan_to_num(iou, nan=0.0, posinf=0.0, neginf=0.0)


def compute_docsim_weight(box_1: np.ndarray, box_2: np.ndarray) -> np.ndarray:
    """DocSim pairing weight of paired boxes [N, 4] on the host, numpy
    (metric_layoutnet.py:204-221)."""
    xc1, yc1, w1, h1 = box_1.T
    xc2, yc2, w2, h2 = box_2.T
    location_difference = ((xc1 - xc2) ** 2 + (yc1 - yc2) ** 2) ** 0.5
    shape_difference = np.abs(w1 - w2) + np.abs(h1 - h2)
    area_factor = np.minimum(w1 * h1, w2 * h2) ** 0.5
    return area_factor * 2 ** (-location_difference - 2.0 * shape_difference)


def masked_mse(pred, tgt, mask):
    """mean((pred-tgt)^2) over valid elements (F.mse_loss on gathered rows):
    divides by (valid rows x trailing feature size)."""
    err = (pred - tgt) ** 2
    while mask.dim() < err.dim():
        mask = mask[..., None]
    m = mask.expand(err.shape).to(err.dtype)
    return (err * m).sum() / m.sum().clamp(min=1.0)


def masked_cross_entropy(logits, labels, mask):
    """mean CE over valid rows (F.cross_entropy on gathered rows).
    logits: [..., L]; labels: [...] int; mask: [...] bool."""
    logits = logits.float()
    nll = torch.logsumexp(logits, dim=-1) - logits.gather(-1, labels[..., None])[..., 0]
    m = mask.to(nll.dtype)
    return (nll * m).sum() / m.sum().clamp(min=1.0)
