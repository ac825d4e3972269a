"""Evaluate Generator checkpoints on a validation set with the port.

    python -m layoutdetr_tpu_torch.evaluate --ckpt runs/00000-x/network-snapshot-000100.pt \\
        --data val.zip [--metrics layout_fid50k_val,...] [--device cuda]

Counterpart of the JAX package's ``evaluate.py:27-126`` (reference
evaluate.py:121-189, without the reference's quirk of one training step
before evaluating): the same options and defaults, argparse instead of
click, plus ``--device`` (default ``cuda``; ``cpu`` only when asked for).

- ``--ckpt`` takes what ``utils.checkpoint.load_generator_checkpoint``
  reads: a training snapshot (its G_ema), a ``save_generator`` file or a
  reference ``.pkl``. Comma-separated paths and globs sweep a run's
  snapshots in one process; every snapshot must have the first one's
  architecture.
- The dataset is re-tokenized to the checkpoint's T and char-length table
  (a run trained with ``--max-text-length auto`` carries its own).
- ``--layoutnet-ckpt`` is a torch LayoutNet state dict (a reference
  ``layoutnet_<dataset>.pth.tar``); ``--inception-ckpt`` a torch
  ``.pth``/``.pt`` in pytorch-fid naming or an ``.npz`` of JAX params.

Each metric's result is printed and appended to
``<run-dir>/metric-<name>.jsonl``. A metric that fails ends the run with
its exception. ``main(argv)`` returns the results.
"""

from __future__ import annotations

import argparse
import glob
from typing import Optional, Sequence

import torch

DEFAULT_METRICS = "layout_fid50k_val,overlap50k_alignment50k_layoutwise_iou50k_layoutwise_docsim50k_val"


def parse_comma_separated_list(s):
    if s is None or s.lower() == "none" or s == "":
        return []
    return s.split(",")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m layoutdetr_tpu_torch.evaluate",
                                 description="Evaluate checkpoints with the PyTorch port.")
    add = ap.add_argument
    add("--ckpt", required=True,
        help="a training snapshot (.pt), a save_generator file or a reference .pkl; "
             "comma-separated paths or a glob sweep a run's snapshots")
    add("--data", required=True, help="validation zip")
    add("--metrics", type=parse_comma_separated_list, default=DEFAULT_METRICS)
    add("--batch", dest="batch_size", type=int, default=16)
    add("--background-size", type=int, default=256)
    add("--max-text-length", type=int, default=256)
    add("--max-items", type=int, default=50000)
    add("--layoutnet-ckpt", default=None,
        help="LayoutNet torch state dict for reference-scale layout FID")
    add("--inception-ckpt", default=None,
        help="InceptionV3 weights (torch .pth in pytorch-fid naming, or a JAX .npz) for "
             "reference-scale image FID")
    add("--seed", type=int, default=0)
    add("--run-dir", default=".")
    add("--device", default="cuda", help="where to evaluate (default cuda)")
    return ap


def load_layoutnet_state_dict(path: str) -> dict:
    """A LayoutNet state dict from a torch file (a ``{"state_dict": ...}``
    wrapper, as in the reference's ``.pth.tar``, is unwrapped)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    return obj["state_dict"] if isinstance(obj.get("state_dict"), dict) else obj


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = build_parser()
    opts = ap.parse_args(argv)
    device = torch.device(opts.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda, but torch sees no CUDA device (--device cpu evaluates on the CPU)")
    from layoutdetr_tpu_torch.metrics import metric_main

    for metric in opts.metrics:
        if not metric_main.is_valid_metric(metric):
            ap.error(f"unknown metric {metric}; valid: {metric_main.list_valid_metrics()}")

    from layoutdetr_tpu_torch.data.dataset import LayoutDataset
    from layoutdetr_tpu_torch.utils.checkpoint import load_generator_checkpoint

    ckpts = []
    for c in opts.ckpt.split(","):
        hits = sorted(p for p in glob.glob(c) if not p.endswith((".json", ".tmp")))
        ckpts.extend(hits or [c])

    dataset = LayoutDataset(opts.data, background_size=opts.background_size,
                            max_text_length=opts.max_text_length)
    cfg_defaults = dict(num_bbox_labels=dataset.num_bbox_labels,
                        background_size=opts.background_size,
                        max_text_length=opts.max_text_length)
    layoutnet = load_layoutnet_state_dict(opts.layoutnet_ckpt) if opts.layoutnet_ckpt else None
    results, gcfg = [], None
    for c in ckpts:
        # every snapshot: a converted checkpoint needs the real WordPiece ids
        dataset.tokenizer.require_hf_for_checkpoint(c)
        G = load_generator_checkpoint(c, device, **cfg_defaults)
        if gcfg is None:
            gcfg = G.cfg
            cfg_defaults["max_text_length"] = gcfg.max_text_length
            if (gcfg.max_text_length != dataset.tokenizer.max_length
                    or gcfg.text_len_table != dataset.tokenizer.length_clip):
                dataset = LayoutDataset(opts.data, background_size=opts.background_size,
                                        max_text_length=gcfg.max_text_length,
                                        text_len_clip=gcfg.text_len_table)
        elif G.cfg != gcfg:
            ap.error(f"{c} was trained with a different architecture than {ckpts[0]}; "
                     "sweep snapshots of one run only")
        for metric in opts.metrics:
            result = metric_main.calc_metric(
                metric, G=G, dataset=dataset, layoutnet_params=layoutnet,
                inception_params=opts.inception_ckpt, batch=opts.batch_size, seed=opts.seed,
                max_items=opts.max_items)
            metric_main.report_metric(result, run_dir=opts.run_dir, snapshot_path=c)
            results.append(dict(result, snapshot_path=c))
        del G
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return results


if __name__ == "__main__":
    main()
