"""Device-resident dataset: upload the dataset once, feed indices per step.

Counterpart of ``layoutdetr_tpu/data/device_cache.py``. What the models
see of a sample is small: a 256x256 background and fixed-shape token
arrays. So every static per-sample array goes to the card once (uint8
backgrounds, int32 token ids, masks and lengths, boxes, labels, validity
mask), and a step ships only the sampler's indices: a small pinned int64
tensor copied without blocking. ``gather_batch`` is then an
``index_select`` and the ImageNet normalisation on the card, and gives
the batch ``LayoutDataset.collate`` gives, as ``data.dataset.to_device``
puts it on the card. ``should_enable`` gates the feed as the JAX package
does (``LAYOUTDETR_DEVICE_CACHE_GB``, default 4).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from layoutdetr_tpu_torch.data.dataset import INDEX_KEYS, MAX_ELEMENTS, RGB_MEAN, RGB_STD

CACHE_KEYS = ("bg_u8", "bboxes", "labels", "text_ids", "text_mask", "text_len", "mask")


def estimate_bytes(dataset) -> int:
    """Device bytes of the cache for ``dataset``."""
    s, t, e = dataset.background_size, dataset.tokenizer.max_length, MAX_ELEMENTS
    return len(dataset) * (s * s * 3 + e * 4 * 4 + e * 4 + e * t * 4 * 2 + e * 4 + e)


def build_host_arrays(dataset) -> dict:
    """Every sample's static decode products, stacked in dataset-index
    order (so sampler indices gather directly)."""
    n, s, t, e = len(dataset), dataset.background_size, dataset.tokenizer.max_length, MAX_ELEMENTS
    out = dict(bg_u8=np.zeros((n, s, s, 3), np.uint8), bboxes=np.zeros((n, e, 4), np.float32),
               labels=np.zeros((n, e), np.int32), text_ids=np.zeros((n, e, t), np.int32),
               text_mask=np.zeros((n, e, t), np.int32), text_len=np.zeros((n, e), np.int32),
               mask=np.zeros((n, e), bool))
    for i in range(n):
        raw = int(dataset._raw_idx[i])
        out["bboxes"][i], out["labels"][i], out["mask"][i] = dataset.layout(raw)
        static = dataset.static(raw)
        for k in ("bg_u8", "text_ids", "text_mask", "text_len"):
            out[k][i] = static[k]
    return out


def gather_batch(cache: dict, idx: torch.Tensor) -> dict:
    """Cache rows at ``idx`` -> the batch ``to_device(collate(idx))`` gives:
    backgrounds ImageNet-normalized float32 channels last, ``INDEX_KEYS``
    int64, ``padding_mask`` derived."""
    b = {k: cache[k].index_select(0, idx) for k in CACHE_KEYS if k != "bg_u8"}
    for k in INDEX_KEYS:  # int32 on the card
        b[k] = b[k].long()
    bg = cache["bg_u8"].index_select(0, idx)
    b["background"] = (bg.float() / 255.0 - cache["rgb_mean"]) / cache["rgb_std"]
    b["padding_mask"] = ~b["mask"]
    return b


class DeviceDatasetCache:
    """Owns the arrays on the card (``CACHE_KEYS`` and the ImageNet
    statistics) and the per-step index feed."""

    def __init__(self, dataset, device):
        self.device = torch.device(device)
        self.nbytes = estimate_bytes(dataset)
        host = dict(build_host_arrays(dataset), rgb_mean=RGB_MEAN, rgb_std=RGB_STD)
        self.arrays = {k: torch.from_numpy(v).to(self.device) for k, v in host.items()}

    def put_indices(self, idxs) -> torch.Tensor:
        """One step's sampler indices on the card."""
        idx = torch.as_tensor(np.asarray(idxs, np.int64))
        if self.device.type == "cuda":
            idx = idx.pin_memory()
        return idx.to(self.device, non_blocking=True)


def should_enable(dataset, mode="auto", budget_gb: Optional[float] = None) -> bool:
    """The device feed's gate: "on", "off", or "auto" = the cache fits the
    budget (env ``LAYOUTDETR_DEVICE_CACHE_GB``, default 4)."""
    if mode in (True, "on"):
        return True
    if mode in (False, "off", None):
        return False
    if budget_gb is None:
        budget_gb = float(os.environ.get("LAYOUTDETR_DEVICE_CACHE_GB", "4"))
    return estimate_bytes(dataset) <= budget_gb * 2 ** 30
