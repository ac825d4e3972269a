"""The val-set layout quality suite: overlap, alignment, layout-wise IoU, DocSim.

Counterpart of ``layoutdetr_tpu/metrics/eval_metrics.py`` (reference
metrics/overlap50k_alignment50k_layoutwise_iou50k_layoutwise_docsim50k.py:20-45,
metric_utils_layout.py:293-339): one G_ema pass over the val items;
overlap and alignment of the generated layouts; IoU and DocSim between the
generated and the real layout of the same conditioning; and the
Hungarian-matched max-IoU / max-DocSim (metric_layoutnet.py:100-150,
229-242). The layout math runs on the host in float64, as JAX's does.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.optimize
import torch

from layoutdetr_tpu_torch.metrics.layout_metrics import (
    compute_alignment,
    compute_docsim_weight,
    compute_iou,
    compute_overlap,
)


def compute_layout_eval_suite(opts, max_items: int = 50000) -> dict:
    from layoutdetr_tpu_torch.metrics.layout_fid import generate_layouts

    n = min(len(opts.dataset), max_items)
    overlaps, alignments, ious, docsims = [], [], [], []
    t0, done, last_logged = time.time(), 0, 0
    for bbox_fake, b in generate_layouts(opts, list(range(n)), batch=opts.get("batch", 16)):
        mask = np.asarray(b["mask"])
        bbox_fake = np.asarray(bbox_fake, np.float64)
        fake_t, mask_t = torch.from_numpy(bbox_fake), torch.from_numpy(mask)
        overlaps.append(compute_overlap(fake_t, mask_t).numpy())
        alignments.append(compute_alignment(fake_t, mask_t).numpy())
        real = np.asarray(b["bboxes"], np.float64)
        for k in range(bbox_fake.shape[0]):
            bf, br = bbox_fake[k][mask[k]], real[k][mask[k]]
            ious.append(float(compute_iou(bf, br).mean()))
            docsims.append(float(compute_docsim_weight(bf, br).mean()))
        done += bbox_fake.shape[0]
        if done - last_logged >= 128 or done >= n:
            last_logged = done
            print(f"[layout_eval_suite] {done}/{n} items ({time.time() - t0:.0f}s)", flush=True)

    return {
        "overlap50k_val": float(np.concatenate(overlaps).mean()),
        "alignment50k_val": float(np.concatenate(alignments).mean()),
        "layoutwise_iou50k_val": float(np.mean(ious)),
        "layoutwise_docsim50k_val": float(np.mean(docsims)),
    }


def _hungarian_score(layout_1, layout_2, pair_fn) -> float:
    """Per label, the max-weight matching of the two layouts' boxes of that
    label under ``pair_fn`` (labels whose counts differ score 0), summed
    and divided by the number of boxes."""
    (bi, li), (bj, lj) = layout_1, layout_2
    score = 0.0
    for label in sorted(set(li.tolist())):
        _bi = bi[np.where(li == label)]
        _bj = bj[np.where(lj == label)]
        m = len(_bi)
        if m == 0 or len(_bj) != m:
            continue
        ii, jj = np.meshgrid(range(m), range(m))
        w = np.asarray(pair_fn(_bi[ii.ravel()], _bj[jj.ravel()])).reshape(m, m)
        rr, cc = scipy.optimize.linear_sum_assignment(w, maximize=True)
        score += w[rr, cc].sum()
    return score / len(bi)


def maximum_iou_for_layout(layout_1, layout_2) -> float:
    """Hungarian-matched per-label IoU (metric_layoutnet.py:100-113)."""
    return _hungarian_score(layout_1, layout_2, compute_iou)


def maximum_docsim_for_layout(layout_1, layout_2) -> float:
    """Hungarian-matched per-label DocSim (metric_layoutnet.py:229-242)."""
    return _hungarian_score(layout_1, layout_2, compute_docsim_weight)
