"""Layout FID: the Fréchet distance of LayoutNet CLS features.

Counterpart of ``layoutdetr_tpu/metrics/layout_fid.py`` (reference
metrics/layout_frechet_inception_distance.py:20-39,
metric_utils_layout.py:199-289, metric_layoutnet.py:26-63): LayoutNet
features of the (bbox, label) pairs of the real val layouts and of G_ema's
layouts for the same conditioning, a Gaussian fit of each, and the Fréchet
distance between them.

LayoutNet weights: a torch state dict in ``opts.layoutnet_params`` (a
reference ``layoutnet_<dataset>.pth.tar`` loads as it is); without one, a
LayoutNet drawn from seed 0 with a warning. Its features are comparable
between checkpoints of one run, but neither reference-scale nor JAX's
(JAX's seed-0 draw is another network). The ads/CGL label remaps apply when
the dataset's name matches (layout_frechet_inception_distance.py:21-22).

``generate_layouts`` runs G_ema (``opts.G``, a ``Generator`` on its
device) under ``torch.inference_mode()``, so BERT's self-attention goes
through the fused attention kernel on a card. Its noise comes from
``z_draws``: one draw a batch from a CPU ``torch.Generator`` seeded by
``opts.seed``.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Callable, Iterator, Tuple

import numpy as np
import torch

from layoutdetr_tpu_torch.data.dataset import to_device
from layoutdetr_tpu_torch.metrics.frechet import frechet_distance, gaussian_stats

REFERENCE_13_LABEL_DATASETS = ("rico", "enrico", "clay", "ads_banner_collection",
                               "AMT_uploaded_ads_banners", "cgl_dataset")
ADS_DATASETS = ("ads_banner_collection", "AMT_uploaded_ads_banners")


def metric_device(opts) -> torch.device:
    """Where the metric's networks run: G_ema's device."""
    return next(opts.G.parameters()).device


def _layoutnet(opts) -> Tuple[Callable, int]:
    """(features fn, number of labels) of the metric's LayoutNet. The
    features fn takes (bbox, label, padding_mask) as numpy arrays or
    tensors and returns [B, 256] float32 numpy features."""
    from layoutdetr_tpu_torch.models.layoutnet import LayoutNet

    name = getattr(opts.dataset, "name", "")
    num_label = 13 if any(k in name for k in REFERENCE_13_LABEL_DATASETS) else 5
    sd = opts.get("layoutnet_params")
    ds_labels = getattr(opts.dataset, "num_bbox_labels", None)
    if sd is not None:
        # given weights define the label space, not the dataset's name
        num_label = int(sd["emb_label.weight"].shape[0])
    elif ds_labels and ds_labels > num_label:
        # the random fallback on a dataset outside the reference's named
        # label spaces: an embedding the size of the dataset's labels
        num_label = int(ds_labels)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = LayoutNet(num_label)
    if sd is None:
        print("[layout_fid] WARNING: no pretrained LayoutNet weights; using seed-0 random "
              "features (self-consistent, not reference-scale)", flush=True)
    else:
        net.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()}, strict=True)
    device = metric_device(opts)
    net = net.to(device).eval()
    remap = dict(label_idx_replace=any(k in name for k in ADS_DATASETS),
                 label_idx_replace_2="cgl_dataset" in name)

    def features(bbox, label, padding_mask) -> np.ndarray:
        label = torch.as_tensor(label)
        if not any(remap.values()) and label.numel() and int(label.max()) >= num_label:
            # reference-named datasets remap into the net's label space;
            # any other label must already be in range
            raise ValueError(f"dataset label id {int(label.max())} is out of range for a "
                             f"{num_label}-label LayoutNet — pass --layoutnet-ckpt weights "
                             "matching the dataset's label space")
        with torch.inference_mode():
            out = net.extract_features(torch.as_tensor(bbox).to(device), label.to(device).long(),
                                       torch.as_tensor(padding_mask).to(device), **remap)
        return out.float().cpu().numpy()

    return features, num_label


def z_draws(seed: int, shape: tuple) -> Callable[[int], torch.Tensor]:
    """The noise of one metric pass: ``draw(n)`` is one N(0, 1) [n, *shape]
    draw from a CPU generator seeded by ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return lambda n: torch.randn((n,) + tuple(shape), generator=gen)


def generate_layouts(opts, indices, batch: int = 16) -> Iterator[Tuple[np.ndarray, dict]]:
    """G_ema over dataset items in batches; yields (bbox_fake [b, 9, 4]
    numpy, the host batch)."""
    G = opts.G
    cfg = G.cfg
    device = metric_device(opts)
    draw = z_draws(opts.get("seed", 0), (cfg.max_elements, cfg.z_dim))
    for i in range(0, len(indices), batch):
        idxs = indices[i:i + batch]
        b = opts.dataset.collate(idxs)
        d = to_device({k: b[k] for k in ("labels", "bboxes", "text_ids", "text_mask", "text_len",
                                         "padding_mask", "background")}, device)
        z = draw(len(idxs)).to(device)
        with torch.inference_mode():
            bbox_fake = G(z, bbox_class=d["labels"], bbox_real=d["bboxes"], text_ids=d["text_ids"],
                          text_mask=d["text_mask"], text_len=d["text_len"],
                          padding_mask=d["padding_mask"], background=d["background"])
        yield bbox_fake.cpu().numpy(), b


def _real_stats_cache_path(opts, n: int, num_label: int) -> str:
    """The real-set statistics' cache file (the reference md5-caches them,
    metric_utils_layout.py:205-222), in the port's own directory: the
    port's seed-0 LayoutNet is not JAX's."""
    ds = opts.dataset
    ident = getattr(ds, "_path", None) or getattr(ds, "name", "ds")
    has_weights = opts.get("layoutnet_params") is not None
    key = hashlib.md5(f"{ident}|{n}|{has_weights}|L{num_label}".encode()).hexdigest()[:16]
    cache_dir = os.path.join(os.path.expanduser("~"), ".cache", "layoutdetr_tpu_torch")
    os.makedirs(cache_dir, exist_ok=True)
    return os.path.join(cache_dir, f"layout-fid-real-{key}.npz")


def compute_layout_fid(opts, max_items: int = 50000) -> float:
    dataset = opts.dataset
    feat_fn, num_label = _layoutnet(opts)
    n = min(len(dataset), max_items)
    indices = list(range(n))
    use_cache = opts.get("cache_real_stats", True)
    cache_path = _real_stats_cache_path(opts, n, num_label) if use_cache else None

    mu_r = sig_r = real = None
    if use_cache and os.path.exists(cache_path):
        with np.load(cache_path) as cached:
            if np.isfinite(cached["mu"]).all() and np.isfinite(cached["sigma"]).all():
                mu_r, sig_r = cached["mu"], cached["sigma"]
        if mu_r is None:  # written by an earlier non-finite pass: recompute
            os.remove(cache_path)
    if mu_r is None:
        real = np.concatenate([
            feat_fn(b["bboxes"], b["labels"], b["padding_mask"])
            for b in (dataset.collate(indices[i:i + 64]) for i in range(0, n, 64))])

    fake_feats = []
    t0, done, last_logged = time.time(), 0, 0
    for bbox_fake, b in generate_layouts(opts, indices, batch=opts.get("batch", 16)):
        fake_feats.append(feat_fn(bbox_fake, b["labels"], b["padding_mask"]))
        done += bbox_fake.shape[0]
        if done - last_logged >= 128 or done >= n:
            last_logged = done
            print(f"[layout_fid] generated {done}/{n} ({time.time() - t0:.0f}s)", flush=True)

    mu_f, sig_f = gaussian_stats(np.concatenate(fake_feats))
    if real is not None:
        mu_r, sig_r = gaussian_stats(real)
        finite = np.isfinite(mu_r).all() and np.isfinite(sig_r).all()
        if not finite:
            print("[layout_fid] WARNING: real-feature stats are non-finite; not caching", flush=True)
        elif use_cache:  # never cache non-finite stats
            np.savez(cache_path, mu=mu_r, sigma=sig_r)
    return frechet_distance(mu_f, sig_f, mu_r, sig_r)
