"""The metric registry: ``calc_metric``, ``report_metric`` and the four metrics.

Counterpart of ``layoutdetr_tpu/metrics/metric_main.py`` (reference
metrics/metric_main.py:32-136): metric functions registered by name,
``calc_metric`` building one options object and timing the run, and
``report_metric`` appending a JSON line to ``metric-<name>.jsonl``.

The options every metric reads: ``G`` (G_ema, a ``Generator`` on the
device the metric runs on), ``dataset`` (a ``LayoutDataset`` of the val
set), ``batch``, ``seed``, ``max_items``; per metric ``layoutnet_params``
(a torch state dict), ``inception_params`` (a path or state dict),
``cache_real_stats``, ``size_canvas``, ``render_dir``, ``max_render``.
"""

from __future__ import annotations

import copy
import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np

_metric_dict: Dict[str, Callable] = {}


class MetricOptions(dict):
    """The options of one metric run: a dict whose keys read as attributes."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None


def register_metric(fn: Callable) -> Callable:
    _metric_dict[fn.__name__] = fn
    return fn


def is_valid_metric(metric: str) -> bool:
    return metric in _metric_dict


def list_valid_metrics() -> list:
    return list(_metric_dict)


def calc_metric(metric: str, **kwargs) -> dict:
    """Run one metric; ``kwargs`` reach it as its options. Returns
    ``{"results": {...}, "metric", "total_time", "total_time_str"}``."""
    if not is_valid_metric(metric):
        raise ValueError(f"unknown metric {metric!r}; valid: {list_valid_metrics()}")
    start = time.time()
    results = _metric_dict[metric](MetricOptions(kwargs))
    total_time = time.time() - start
    return dict(results=dict(results), metric=metric, total_time=total_time,
                total_time_str=f"{int(total_time)}s")


def report_metric(result_dict: dict, run_dir: Optional[str] = None,
                  snapshot_path: Optional[str] = None) -> None:
    """Print the result as one JSON line, and append it to
    ``<run_dir>/metric-<name>.jsonl`` when ``run_dir`` is a directory."""
    line = json.dumps(dict(result_dict, snapshot_path=snapshot_path, timestamp=time.time()))
    print(line, flush=True)
    if run_dir is not None and os.path.isdir(run_dir):
        with open(os.path.join(run_dir, f"metric-{result_dict['metric']}.jsonl"), "a") as f:
            f.write(line + "\n")


# ----------------------------------------------------------------------------
# the registered metrics (reference metrics/metric_main.py:90-136)

@register_metric
def layout_fid50k_val(opts):
    from layoutdetr_tpu_torch.metrics.layout_fid import compute_layout_fid

    return {"layout_fid50k_val": compute_layout_fid(opts, max_items=opts.get("max_items") or 50000)}


@register_metric
def overlap50k_alignment50k_layoutwise_iou50k_layoutwise_docsim50k_val(opts):
    from layoutdetr_tpu_torch.metrics.eval_metrics import compute_layout_eval_suite

    return compute_layout_eval_suite(opts, max_items=opts.get("max_items") or 50000)


@register_metric
def fid50k_val(opts):
    from layoutdetr_tpu_torch.metrics.image_fid import compute_image_fid

    return {"fid50k_val": compute_image_fid(opts, max_items=opts.get("max_items") or 50000)}


# Per-label HTML element specs (rendering_utils.py:34-118): the template
# has specs for header(0), body(3), disclaimer/footnote(4) and button(5)
# only; a page with any other label is skipped.
_RENDER_SPECS = {
    0: {"type": "header", "style": {"fontFamily": "Arial", "color": "", "fontFormat": "bold"}},
    3: {"type": "body", "style": {"fontFamily": "Arial", "color": ""}},
    5: {"type": "button", "buttonParams": {"backgroundColor": "", "backgroundImage": "", "radius": 0.5},
        "style": {"fontFamily": "Arial", "color": ""}},
    4: {"type": "disclaimer / footnote", "style": {"fontFamily": "Arial", "color": ""}},
}


def _renderable(labels: list) -> bool:
    """The reference's filter (rendering_utils.py:153-167): at most 4
    elements, only renderable types, each at most once."""
    return (len(labels) <= 4 and all(lab in _RENDER_SPECS for lab in labels)
            and len(set(labels)) == len(labels))


@register_metric
def rendering_val(opts):
    """Render generated and real banners side by side into
    ``<render_dir>/rendering_fake/`` and ``rendering_real/`` at the original
    page size (rendering_utils.py:99-301), for the val layouts that pass
    the reference filter. The fakes are center-aligned and de-overlapped
    first (:151-152), each sample on its own: the post-processors are
    batch-1 functions. The scan is capped by ``max_render``, else
    ``max_items``, else 64 items (an uncapped scan each snapshot tick would
    stall training on a large val set); a cap is logged."""
    import PIL.Image

    from layoutdetr_tpu_torch.data.dataset import LayoutDataset, denormalize_image
    from layoutdetr_tpu_torch.metrics.layout_fid import generate_layouts
    from layoutdetr_tpu_torch.serving.postprocess import de_overlap, horizontal_center_aligned
    from layoutdetr_tpu_torch.serving.render import visualize_banner

    out_root = opts.get("render_dir", "rendered_val")
    fake_dir = os.path.join(out_root, "rendering_fake")
    real_dir = os.path.join(out_root, "rendering_real")
    os.makedirs(fake_dir, exist_ok=True)
    os.makedirs(real_dir, exist_ok=True)

    # original-resolution backgrounds, resized to the page (rendering_utils.py:173-177)
    ds = opts.dataset
    dataset = LayoutDataset(ds._path, background_size=ds.background_size, tokenizer=ds.tokenizer,
                            load_background_orig=True)
    opts = MetricOptions(opts, dataset=dataset)
    cap = opts.get("max_render") or opts.get("max_items")
    capped_by = "max_render" if opts.get("max_render") else "max_items"
    if not cap:
        cap, capped_by = 64, "default (pass --max-items to widen)"
    n = min(len(dataset), cap)
    if n < len(dataset):
        print(f"rendering_val: scanning {n} of {len(dataset)} val items (capped by {capped_by})")
    rendered = item_idx = 0
    for bbox_fake, b in generate_layouts(opts, list(range(n)), batch=opts.get("batch", 16)):
        bbox_fake = np.stack([
            de_overlap(horizontal_center_aligned(bbox_fake[k:k + 1], b["mask"][k:k + 1]),
                       b["mask"][k:k + 1])[0]
            for k in range(bbox_fake.shape[0])])
        for k in range(bbox_fake.shape[0]):
            mask, labels = b["mask"][k], b["labels"][k]
            this_idx, item_idx = item_idx, item_idx + 1
            # filter before re-reading the item: most layouts are rejected
            if not _renderable(labels[mask].tolist()):
                continue
            item = dataset[this_idx]
            bg = PIL.Image.fromarray(denormalize_image(np.asarray(item["background_orig"]))).resize(
                (int(item["W_page"]), int(item["H_page"])), PIL.Image.BILINEAR)
            elements = []
            for j in np.flatnonzero(mask):
                spec = copy.deepcopy(_RENDER_SPECS[int(labels[j])])
                spec["text"] = item["texts"][j]
                elements.append(spec)
            name = str(item.get("name", f"render_{rendered:04d}")).replace(".json", "")
            visualize_banner(bbox_fake[k][mask], mask[mask], elements, True, bg, None, ["image"],
                             os.path.join(fake_dir, name))
            visualize_banner(b["bboxes"][k][mask], mask[mask], elements, True, bg, None, ["image"],
                             os.path.join(real_dir, name))
            rendered += 1
    return {"rendering_val": rendered, "rendering_fake_dir": fake_dir, "rendering_real_dir": real_dir}
