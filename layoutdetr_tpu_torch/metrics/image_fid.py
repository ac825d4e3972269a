"""Image FID of layouts composited onto their backgrounds.

Counterpart of ``layoutdetr_tpu/metrics/image_fid.py`` (reference
metrics/frechet_inception_distance.py:20-39, metric_utils.py:199-299): the
real element patches pasted at the real and at the generated positions
onto the original background (``metrics/compositing.py``), InceptionV3's
2048-d pool3 features of both sets (``models/inception.py``, weights from
``opts.inception_params``), and the Fréchet distance between them.

Two fallbacks, each announced by a warning:
- no Inception weights: features of a fixed 3-layer random convolution
  drawn from seed 0 (the port's own draw, not JAX's; comparable between
  checkpoints of one run, not reference-scale);
- a dataset without patch or original-background images: translucent
  label-colored boxes over the training-resolution backgrounds
  (``render_layout_batch``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from layoutdetr_tpu_torch.metrics.frechet import frechet_distance, gaussian_stats
from layoutdetr_tpu_torch.serving.postprocess import convert_xywh_to_ltrb, label_palette


def render_layout_batch(bboxes, labels, masks, backgrounds) -> np.ndarray:
    """The fallback compositor: label-colored boxes blended 0.4 onto
    [B, S, S, 3] float backgrounds."""
    colors = np.asarray(label_palette(13), np.float32) / 255.0
    out = np.array(backgrounds, np.float32, copy=True)
    b, s = out.shape[0], out.shape[1]
    for k in range(b):
        for i in range(bboxes.shape[1]):
            if not masks[k, i]:
                continue
            x1, y1, x2, y2 = convert_xywh_to_ltrb(bboxes[k, i])
            xs, xe = int(np.clip(x1 * s, 0, s)), int(np.clip(x2 * s, 0, s))
            ys, ye = int(np.clip(y1 * s, 0, s)), int(np.clip(y2 * s, 0, s))
            c = colors[int(labels[k, i]) % len(colors)]
            out[k, ys:ye, xs:xe] = 0.6 * out[k, ys:ye, xs:xe] + 0.4 * c
    return out


def random_conv_features(device):
    """The no-weights fallback: uint8 NHWC images -> [B, 128] features of
    three ReLU convolutions (5x5/4, 3x3/2, 3x3/2, 'same' padding) with
    weights N(0, 0.1^2) from a CPU generator seeded 0."""
    gen = torch.Generator().manual_seed(0)
    layers = [(torch.randn(cout, cin, k, k, generator=gen) * 0.1).to(device)
              for cin, cout, k in ((3, 32, 5), (32, 64, 3), (64, 128, 3))]

    def features(imgs: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(imgs)).to(device).permute(0, 3, 1, 2).float() / 255
        with torch.inference_mode():
            for w, stride in zip(layers, (4, 2, 2)):
                x = F.relu(_conv_same(x, w, stride))
            return x.mean(dim=(2, 3)).cpu().numpy()

    return features


def _conv_same(x, w, stride: int):
    """XLA's 'SAME' padding: output ceil(in / stride), the extra pixel of
    an odd total pad at the end."""
    pads = []
    for size, k in zip(reversed(x.shape[2:]), reversed(w.shape[2:])):
        total = max((-(-size // stride) - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(F.pad(x, pads), w, stride=stride)


def _feature_fn(opts):
    """uint8 [B, S, S, 3] images -> [B, D] features on G_ema's device."""
    from layoutdetr_tpu_torch.metrics.layout_fid import metric_device

    device = metric_device(opts)
    src = opts.get("inception_params")
    if src is not None:
        from layoutdetr_tpu_torch.models.inception import load_inception_params, make_feature_fn

        return make_feature_fn(load_inception_params(src, device))
    print("[image_fid] WARNING: no Inception weights provided (opts.inception_params); using "
          "seed-0 random conv features (self-consistent, not reference-scale)", flush=True)
    return random_conv_features(device)


def _patch_dataset(opts):
    """The val set with patches and original backgrounds decoded, or None
    (with a warning) when its zip has none."""
    from layoutdetr_tpu_torch.data.dataset import LayoutDataset

    ds = opts.dataset
    if getattr(ds, "load_patches", False) and getattr(ds, "load_background_orig", False):
        return ds
    pds = LayoutDataset(ds._path, background_size=ds.background_size, tokenizer=ds.tokenizer,
                        load_patches=True, load_background_orig=True)
    try:
        pds[0]  # patches decode lazily: a zip without them raises here
    except KeyError as e:
        print(f"[image_fid] WARNING: dataset has no patch/orig images ({e}); falling back to "
              "label-colored box compositing", flush=True)
        return None
    return pds


def compute_image_fid(opts, max_items: int = 50000) -> float:
    from layoutdetr_tpu_torch.data.dataset import denormalize_image
    from layoutdetr_tpu_torch.metrics.compositing import composite_batch
    from layoutdetr_tpu_torch.metrics.layout_fid import generate_layouts
    from layoutdetr_tpu_torch.metrics.metric_main import MetricOptions

    max_items = opts.get("max_items", max_items) or max_items
    feat = _feature_fn(opts)
    size_canvas = opts.get("size_canvas", 1024)
    pds = _patch_dataset(opts)
    if pds is not None:
        opts = MetricOptions(opts, dataset=pds)
    n = min(len(opts.dataset), max_items)
    real_feats, fake_feats = [], []
    for bbox_fake, b in generate_layouts(opts, list(range(n)), batch=opts.get("batch", 16)):
        if pds is not None:
            common = (b["patches_orig"], b["mask"], b["background_orig"], b["W_page"], b["H_page"],
                      size_canvas)
            real_img = composite_batch(b["bboxes"], b["bboxes"], *common)
            fake_img = composite_batch(bbox_fake, b["bboxes"], *common)
        else:
            real_img = denormalize_image(render_layout_batch(b["bboxes"], b["labels"], b["mask"],
                                                             b["background"]))
            fake_img = denormalize_image(render_layout_batch(bbox_fake, b["labels"], b["mask"],
                                                             b["background"]))
        real_feats.append(feat(real_img))
        fake_feats.append(feat(fake_img))

    mu_f, sig_f = gaussian_stats(np.concatenate(fake_feats))
    mu_r, sig_r = gaussian_stats(np.concatenate(real_feats))
    return frechet_distance(mu_f, sig_f, mu_r, sig_r)
