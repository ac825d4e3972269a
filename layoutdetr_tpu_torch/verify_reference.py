"""One command from the reference's released files to the port's numbers.

    python -m layoutdetr_tpu_torch.verify_reference \\
        --pkl /path/layoutdetr_ad_banner.pkl --data /path/ads/val.zip \\
        --vocab-dir /path/bert-base-uncased \\
        [--layoutnet /path/layoutnet_ads.pth.tar] \\
        [--inception /path/pt_inception-2015-12-05.pth] \\
        [--max-items 50000] [--out reference_parity_run] [--device cuda]

    python -m layoutdetr_tpu_torch.verify_reference --dry-run OUT_DIR [--device cuda]

Counterpart of ``tools/verify_reference_artifacts.{py,sh}``. The chain:

1. the snapshot pickle through ``utils.legacy_pkl.load_network_pkl`` (no
   code of the pickle runs), the Generator config inferred from the
   weights' shapes, the tensor count printed;
2. a fixed-seed G_ema forward over the first ``min(4, len)`` val items
   (``fixed_seed_forward``; z from a CPU ``torch.Generator`` seeded 0,
   saved beside the boxes): ``OUT/bbox_fixed_seed.npz`` and the md5 of the
   boxes rounded to 5 decimals, after the tokenizer's check that a
   reference snapshot gets a WordPiece vocab;
3. ``evaluate.main`` with the reference's metrics (``METRICS_REAL``: the
   layout FID, the image FID and the layout suite), on ``--layoutnet`` /
   ``--inception`` where given and on the random-feature fallbacks
   otherwise, each named as such in the report;
4. a dated section appended to ``OUT/PARITY.md``.

The JAX tool's ``tools/extract_reference_pkl.py`` has no counterpart: the
port reads the pickle itself. ``--dry-run OUT_DIR`` runs the same chain on
synthetic files made there: a 30,522-line vocab, a ``GeneratorConfig()``
Generator pickled as the reference dumps a snapshot, and a val.zip from
``data/synthetic.py``. Nothing is downloaded.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import glob
import hashlib
import json
import os
import pickle
import time
from typing import Optional, Sequence

import numpy as np
import torch

from layoutdetr_tpu_torch.config import GeneratorConfig

METRICS_REAL = ("layout_fid50k_val,fid50k_val,"
                "overlap50k_alignment50k_layoutwise_iou50k_layoutwise_docsim50k_val")
FORWARD_ITEMS = 4  # the digest forward's val items
Z_SEED = 0
DRY_RUN_ITEMS = 8  # the dry run's val.zip
VOCAB_LINES = 30522


def md5_head(path: str, limit_mb: int = 64) -> str:
    """md5 of a file's first ``limit_mb`` MB (a 2.7 GB pickle in one read)."""
    h = hashlib.md5()
    todo = limit_mb << 20
    with open(path, "rb") as f:
        while todo > 0:
            chunk = f.read(min(1 << 20, todo))
            if not chunk:
                break
            h.update(chunk)
            todo -= len(chunk)
    return h.hexdigest()


def make_vocab(out_dir: str) -> str:
    """A ``bert-base-uncased``-shaped vocab.txt (30,522 lines, the real
    special ids 0 and 100-103, single characters and their ``##`` forms);
    returns its directory."""
    vocab_dir = os.path.join(out_dir, "bert-base-uncased")
    os.makedirs(vocab_dir, exist_ok=True)
    chars = "abcdefghijklmnopqrstuvwxyz0123456789"
    pieces = list(chars) + ["##" + c for c in chars]
    specials = {0: "[PAD]", 100: "[UNK]", 101: "[CLS]", 102: "[SEP]", 103: "[MASK]"}
    with open(os.path.join(vocab_dir, "vocab.txt"), "w", encoding="utf-8") as f:
        for i in range(VOCAB_LINES):
            j = i - 1000
            f.write(specials.get(i) or (pieces[j] if 0 <= j < len(pieces) else f"tok{i}"))
            f.write("\n")
    return vocab_dir


def make_pkl(out_dir: str, cfg: GeneratorConfig, seed: int = 0) -> str:
    """A Generator at ``cfg`` (weights from ``seed``) pickled as the
    reference's training loop dumps a snapshot (plain pickle of the live
    modules, training_loop.py:396-411)."""
    from layoutdetr_tpu_torch.models.generator import Generator

    path = os.path.join(out_dir, "synthetic_snapshot.pkl")
    torch.manual_seed(seed)
    g = Generator(cfg).eval()
    with open(path, "wb") as f:
        pickle.dump(dict(G=None, D=None, G_ema=g, augment_pipe=None,
                         training_set_kwargs={"max_elements": cfg.max_elements}), f)
    return path


def make_val_zip(out_dir: str, items: int, image_size: int) -> str:
    from layoutdetr_tpu_torch.data.synthetic import make_synthetic_zip

    return make_synthetic_zip(os.path.join(out_dir, "val.zip"), num_samples=items,
                              image_size=image_size, max_elements=9, seed=1, structured=True)


def fixed_z(n: int, cfg: GeneratorConfig) -> torch.Tensor:
    """The digest forward's noise: [n, max_elements, z_dim] from a CPU
    ``torch.Generator`` seeded ``Z_SEED``."""
    return torch.randn(n, cfg.max_elements, cfg.z_dim,
                       generator=torch.Generator().manual_seed(Z_SEED))


def fixed_seed_forward(G, batch: dict, z: torch.Tensor) -> np.ndarray:
    """G's boxes [n, N, 4] (fp32) for a collated val batch and ``z``, at
    ``reconst=False``, on G's device."""
    from layoutdetr_tpu_torch.data.dataset import to_device

    dev = next(G.parameters()).device
    t = to_device(batch, dev)
    with torch.no_grad():
        bbox = G(z=z.to(dev), bbox_class=t["labels"], bbox_real=t["bboxes"],
                 text_ids=t["text_ids"], text_mask=t["text_mask"], text_len=t["text_len"],
                 padding_mask=~t["mask"], background=t["background"])
    return bbox.float().cpu().numpy()


def digest(bbox: np.ndarray) -> str:
    return hashlib.md5(np.round(bbox, 5).tobytes()).hexdigest()[:16]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m layoutdetr_tpu_torch.verify_reference",
                                 description="The reference snapshot through the port's chain: "
                                             "conversion, a fixed-seed forward, the metrics.")
    add = ap.add_argument
    add("--pkl", help="reference snapshot .pkl (layoutdetr_ad_banner.pkl)")
    add("--data", help="val.zip (the dataset tool's output)")
    add("--vocab-dir", help="directory holding bert-base-uncased's vocab.txt")
    add("--layoutnet", help="LayoutNet state dict (layoutnet_<dataset>.pth.tar)")
    add("--inception", help="FID InceptionV3 weights (pytorch-fid naming .pth, or a JAX .npz)")
    add("--max-items", type=int, default=50000)
    add("--out", default="reference_parity_run", help="results directory")
    add("--device", default="cuda", help="where the chain runs (default cuda)")
    add("--dry-run", metavar="OUT_DIR",
        help="make synthetic files in OUT_DIR and run the same chain there")
    # for the tests and the card's smoke run: the dry run's G and val.zip
    add("--dry-run-config", default="{}", help=argparse.SUPPRESS)
    add("--dry-run-items", type=int, default=DRY_RUN_ITEMS, help=argparse.SUPPRESS)
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the chain; returns the digest, the metric results and the paths."""
    from layoutdetr_tpu_torch import evaluate
    from layoutdetr_tpu_torch.data.dataset import LayoutDataset
    from layoutdetr_tpu_torch.utils.checkpoint import generator_from_network_pkl
    from layoutdetr_tpu_torch.utils.legacy_pkl import infer_generator_config, load_network_pkl

    ap = build_parser()
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda, but torch sees no CUDA device (--device cpu runs on the CPU)")
    background_size = 256  # the reference's; a snapshot does not record it
    if args.dry_run:
        out_dir = os.path.abspath(args.dry_run)
        os.makedirs(out_dir, exist_ok=True)
        cfg = GeneratorConfig(**json.loads(args.dry_run_config))
        background_size = cfg.background_size
        args.vocab_dir = make_vocab(out_dir)
        args.pkl = make_pkl(out_dir, cfg)
        args.data = make_val_zip(out_dir, args.dry_run_items, cfg.background_size)
        print(f"[dry-run] synthetic vocab, val.zip ({args.dry_run_items} items) and snapshot "
              f"({os.path.getsize(args.pkl) / 1e9:.3f} GB) in {out_dir}")
    else:
        out_dir = os.path.abspath(args.out)
        os.makedirs(out_dir, exist_ok=True)
    if not args.pkl or not args.data:
        ap.error("--pkl and --data are required (or --dry-run OUT_DIR)")
    if args.vocab_dir:
        os.environ["LAYOUTDETR_BERT_VOCAB"] = args.vocab_dir

    section = [f"\n## Reference-artifact verification (port) — "
               f"{datetime.date.today().isoformat()}"
               f"{' (DRY RUN, synthetic files)' if args.dry_run else ''}\n"]
    section.append(f"- snapshot: `{args.pkl}` (md5 of the first 64 MB `{md5_head(args.pkl)}`)")
    section.append(f"- val data: `{args.data}`")
    section.append(f"- vocab: `{args.vocab_dir or 'none (hash tokenizer)'}`")
    section.append(f"- device: {device}"
                   + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))

    # 1. the pickle, no code executed
    seconds = {}
    t0 = time.perf_counter()
    print(f"[1/3] reading {args.pkl} with the restricted unpickler...")
    nets = load_network_pkl(args.pkl)
    entry = nets.get("G_ema") or nets.get("G")
    if entry is None:
        raise ValueError(f"{args.pkl} contains no G_ema/G module")
    which = "G_ema" if nets.get("G_ema") else "G"
    n_tensors = len(entry["state_dict"])
    inferred = infer_generator_config(entry["state_dict"])
    G = generator_from_network_pkl(nets, device, name=args.pkl, background_size=background_size)
    del nets, entry
    gcfg = G.cfg
    seconds["read"] = time.perf_counter() - t0
    print(f"      {n_tensors} tensors; inferred {inferred}")
    section.append(f"- conversion: {n_tensors} tensors of {which}; inferred BERT "
                   f"{gcfg.bert_num_encoder_layers}+{gcfg.bert_num_decoder_layers} x "
                   f"{gcfg.bert_f_dim}, T={gcfg.max_text_length}, background "
                   f"{gcfg.background_size} (not in a snapshot: the reference's)")

    # 2. the fixed-seed forward
    t0 = time.perf_counter()
    dataset = LayoutDataset(args.data, background_size=gcfg.background_size,
                            max_text_length=gcfg.max_text_length,
                            text_len_clip=gcfg.text_len_table)
    dataset.tokenizer.require_hf_for_checkpoint(args.pkl)
    n = min(FORWARD_ITEMS, len(dataset))
    z = fixed_z(n, gcfg)
    print(f"[2/3] fixed-seed G_ema forward over the first {n} val items...")
    bbox = fixed_seed_forward(G, dataset.collate(list(range(n))), z)
    del G
    seconds["forward"] = time.perf_counter() - t0
    if not np.isfinite(bbox).all():
        raise FloatingPointError("non-finite boxes from the converted snapshot")
    np.savez(os.path.join(out_dir, "bbox_fixed_seed.npz"), bbox=bbox, z=z.numpy())
    dig = digest(bbox)
    z_src = (f"torch.randn({n}, {gcfg.max_elements}, {gcfg.z_dim}) on a CPU torch.Generator "
             f"seeded {Z_SEED}, saved as z")
    print(f"      bbox {list(bbox.shape)} mean {bbox.mean():.6f} std {bbox.std():.6f} "
          f"digest {dig}; z: {z_src}")
    section.append(f"- fixed-seed bbox forward ({dataset.tokenizer.backend} tokenizer): shape "
                   f"{list(bbox.shape)}, mean {bbox.mean():.6f}, std {bbox.std():.6f}, "
                   f"digest(round5) `{dig}`; z: {z_src} (`bbox_fixed_seed.npz`; run the "
                   f"reference on the same z to close bbox parity)")
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # 3. the reference's metrics through the evaluation CLI
    cmd = ["--ckpt", args.pkl, "--data", args.data, "--metrics", METRICS_REAL,
           "--max-items", str(args.max_items), "--run-dir", out_dir, "--device", args.device,
           "--background-size", str(gcfg.background_size)]
    if args.layoutnet:
        cmd += ["--layoutnet-ckpt", args.layoutnet]
    if args.inception:
        cmd += ["--inception-ckpt", args.inception]
    print(f"[3/3] python -m layoutdetr_tpu_torch.evaluate {' '.join(cmd)}")
    t0 = time.perf_counter()
    evaluate.main(cmd)
    seconds["evaluate"] = time.perf_counter() - t0
    results = {}
    for path in sorted(glob.glob(os.path.join(out_dir, "metric-*.jsonl"))):
        with open(path) as f:
            for line in f:
                results.update(json.loads(line).get("results", {}))
    section.append("- layout-FID features: " + ("the LayoutNet of `--layoutnet`" if args.layoutnet
                   else "FALLBACK seed-0 random LayoutNet (not reference scale)")
                   + "; image-FID features: " + ("the InceptionV3 of `--inception`"
                   if args.inception else "FALLBACK seed-0 random convolution (not reference "
                                          "scale)"))
    for k, v in sorted(results.items()):
        section.append(f"- `{k}` = {v:.6g}")
    section.append("- seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items()))
    section.append(f"- files: `{out_dir}/`")

    # 4. the report
    report = os.path.join(out_dir, "PARITY.md")
    with open(report, "a") as f:
        f.write("\n".join(section) + "\n")
    print(f"\nAppended the results to {report}")
    print("\n".join(section))
    return dict(out_dir=out_dir, pkl=args.pkl, data=args.data, n_tensors=n_tensors,
                config=dataclasses.asdict(gcfg), bbox=bbox, z=z.numpy(), digest=dig,
                results=results, report=report, seconds=seconds)


if __name__ == "__main__":
    main()
