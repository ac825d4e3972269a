"""Benchmark of the port: the GAN train step's throughput, or with
``--infer`` the Generator forward's, in images a second on one device.

    python -m layoutdetr_tpu_torch.bench [--fp32] [--text-len 256] [--batch 16]
    python -m layoutdetr_tpu_torch.bench --infer
    python -m layoutdetr_tpu_torch.bench --smoke --device cpu

Counterpart of the root ``bench.py`` (:201-478), with the same options,
defaults and output: ONE JSON line on stdout,

    {"metric": "gan_train_step_throughput" | "gan_inference_throughput",
     "value": N, "unit": "imgs/sec/chip", "vs_baseline": N,
     "baseline_source": "derived" | "fallback", "value_sustained": N,
     "value_burst": N, "vs_baseline_burst": N}

(the unit keeps the JAX bench's name, so one reader parses both), and
diagnostics on stderr: the card and its power limit, FLOPs an image,
achieved TFLOP/s, MFU and peak memory. ``--device`` (default ``cuda``)
picks the device; there is no fallback to another.

Workload (the JAX bench's): ``GeneratorConfig()`` G and D at full width
with the port's own initialisation from ``--seed``, batch 16, text masks
with ``--valid-tokens`` valid tokens of ``--text-len``, bf16 (fp32 with
``--fp32``; TF32 is off either way, the port's fp32 contract). The train
step is ``training.train_step.make_train_step``: the shared hoisted text
pass through the attention kernel with dropout, Gmain, Adam, Dmain with
the bg_decoder's ``bias_act`` kernel, Adam, EMA; each step draws its
randomness from a CPU ``torch.Generator`` seeded with the step's number.
``--infer`` times G's forward at ``reconst=False``, deterministic, under
``torch.inference_mode()`` (the attention kernel runs only where no
gradient is recorded), on inputs uploaded once.

Timing: a burst window (``--burst-steps``) and then the sustained window
(``--steps``, the headline ``value``), each on the host clock between two
``torch.cuda.synchronize()`` calls, after ``--warmup`` steps.

FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over one step (or
forward) before the timed ones. The two kernels launch through ctypes on
raw pointers, where the counter cannot see them, so that step runs the
port's plain attention (the same products); ``bias_act`` is elementwise
and is not counted on either path. XLA's count, which the JAX bench
reads, also counts elementwise work.

Baseline (derived, as the JAX bench's): the reference's per-A100
throughput is taken as ``312 TFLOP/s x 10% / (FLOPs an image)``;
``baseline_source`` is ``derived`` when the count succeeds and
``fallback`` (5 images/s train, 25 inference) otherwise.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from layoutdetr_tpu_torch.config import GeneratorConfig
from layoutdetr_tpu_torch.models.bert import BertSelfAttention
from layoutdetr_tpu_torch.training.optimizers import build_optimizer
from layoutdetr_tpu_torch.training.train_loop import init_models
from layoutdetr_tpu_torch.training.train_step import GANTrainState, make_train_step
from layoutdetr_tpu_torch.utils.profiling import trace

A100_PEAK_FLOPS = 312e12  # bf16 dense
REF_ASSUMED_MFU = 0.10
FALLBACK_REF_IMGS_PER_SEC = 5.0
FALLBACK_REF_INFER_IMGS_PER_SEC = 25.0
# H100 SXM data sheet, dense: bf16 on the tensor cores, fp32 on the CUDA
# cores (TF32 off)
H100_PEAK_TFLOPS = {torch.bfloat16: 989.0, torch.float32: 67.0}
# XLA's count of the JAX train step, bf16, T=256, an image (docs/BENCH_NOTES.md:130)
JAX_TRAIN_FLOPS_PER_IMG = 1.932e12
SMOKE = dict(hidden_dim=16, bert_f_dim=32, bert_num_heads=2, bert_num_encoder_layers=1,
             bert_num_decoder_layers=1, im_f_dim=16, max_text_length=16, vocab_size=64,
             bos_token_id=62, nhead=2, num_encoder_layers=1, num_decoder_layers=1,
             reconst_decoder_layers=1, uncond_encoder_layers=1, dim_feedforward=32,
             background_size=32, max_elements=3)


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def example_batch(cfg: GeneratorConfig, b: int, t: int, valid_tokens: int, device,
                  seed: int = 0) -> dict:
    """The JAX bench's batch (``__graft_entry__._example_batch``) with
    ``valid_tokens`` valid tokens a text, in the train step's keys plus z,
    on ``device``."""
    rng = np.random.default_rng(seed)
    n, s = cfg.max_elements, cfg.background_size
    z = rng.normal(size=(b, n, cfg.z_dim)).astype(np.float32)
    labels = rng.integers(0, cfg.num_bbox_labels, size=(b, n))
    bboxes = rng.uniform(0.1, 0.9, size=(b, n, 4)).astype(np.float32)
    text_ids = rng.integers(1, min(cfg.vocab_size - 4, 30000), size=(b, n, t))
    text_mask = np.zeros((b, n, t), np.int32)
    text_mask[..., :min(valid_tokens, t)] = 1
    text_len = rng.integers(0, cfg.max_text_length, size=(b, n))
    background = rng.normal(size=(b, s, s, 3)).astype(np.float32)
    arrays = dict(z=z, labels=labels, bboxes=bboxes, text_ids=text_ids, text_mask=text_mask,
                  text_len=text_len, mask=np.ones((b, n), bool), background=background)
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def attention_layers(modules: Sequence[torch.nn.Module]) -> list:
    """Every BERT self-attention in ``modules``: ``flash_attention`` is its
    switch between the fused kernel and the plain version."""
    return [m for mod in modules for m in mod.modules() if isinstance(m, BertSelfAttention)]


@contextlib.contextmanager
def plain_attention(modules: Sequence[torch.nn.Module]):
    """Inside, every BERT self-attention of ``modules`` runs the plain version."""
    layers = attention_layers(modules)
    prev = [m.flash_attention for m in layers]
    for m in layers:
        m.flash_attention = False
    try:
        yield
    finally:
        for m, v in zip(layers, prev):
            m.flash_attention = v


def count_flops(fn, modules: Sequence[torch.nn.Module]) -> Optional[float]:
    """FLOPs of one ``fn()`` on the plain attention path (the counter does
    not see the kernels); None when the count fails."""
    from torch.utils.flop_counter import FlopCounterMode

    try:
        with plain_attention(modules), FlopCounterMode(display=False) as counter:
            fn()
        return float(counter.get_total_flops()) or None
    except (RuntimeError, NotImplementedError) as e:
        log(f"FLOP count failed ({type(e).__name__}: {e}); the baseline falls back")
        return None


def train_state(G: torch.nn.Module, D: torch.nn.Module) -> GANTrainState:
    """G and D with the train step's optimizers (lazy regularization
    intervals 4 and 16, as the training run's)."""
    return GANTrainState.create(G, D, build_optimizer(G.train(), reg_interval=4),
                                build_optimizer(D.train(), reg_interval=16))


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader", f"--id={device.index or 0}"],
                              capture_output=True, text=True, check=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"{torch.cuda.get_device_name(device)} (power limit unread: {e})"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true", help="tiny config (CPU tests)")
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    ap.add_argument("--batch", type=int, default=None, help="default 16 (smoke: 2)")
    ap.add_argument("--burst-steps", type=int, default=6, help="short window, timed first")
    ap.add_argument("--steps", type=int, default=24, help="sustained window (the headline)")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--text-len", type=int, default=256,
                    help="tokens a text: the reference's max_length=256 (networks_detr.py:145)")
    ap.add_argument("--valid-tokens", type=int, default=16,
                    help="tokens marked valid a text (ad strings are short)")
    ap.add_argument("--fp32", action="store_true", help="fp32 without TF32 (default bf16)")
    ap.add_argument("--peak-tflops", type=float, default=None,
                    help="the card's peak for the MFU diagnostic (default: the H100 SXM's "
                         "dense peak for the dtype, 989 bf16 / 67 fp32)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace of the timed windows into DIR")
    ap.add_argument("--infer", action="store_true",
                    help="bench G's forward (the serving path) instead of the train step")
    ap.add_argument("--no-flash", action="store_true",
                    help="plain attention in the text encoders instead of the fused kernel")
    ap.add_argument("--no-share-text-encoder", action="store_true",
                    help="run G's and D's frozen text encoders separately")
    ap.add_argument("--seed", type=int, default=0, help="weights and inputs")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the bench; print its JSON line on stdout and return it with the
    diagnostics (``flops_per_step``, ``mfu``, ``peak_memory_gib``,
    ``card``, the number of ``calls`` of each kind)."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device; pass --device cpu to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.smoke:
        cfg, b, t = GeneratorConfig(**SMOKE), args.batch or 2, 8
    else:
        cfg, b, t = GeneratorConfig(), args.batch or 16, args.text_len
    dtype = torch.float32 if (args.fp32 or args.smoke) else torch.bfloat16
    peak = args.peak_tflops or H100_PEAK_TFLOPS[dtype]
    card = card_line(device)
    log(f"device {card}; {'infer' if args.infer else 'train'} {str(dtype)[6:]} batch {b} T={t}"
        + (f", peak {peak:g} TFLOP/s for MFU" if device.type == "cuda" else ""))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    G, D = init_models(cfg, device, dtype, args.seed)
    if args.no_flash:
        for m in attention_layers((G, D)):
            m.flash_attention = False
    batch = example_batch(cfg, b, t, args.valid_tokens, device, args.seed)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    if args.infer:
        G.eval().requires_grad_(False)
        del D
        inputs = dict(z=batch["z"], bbox_class=batch["labels"], bbox_real=None,
                      text_ids=batch["text_ids"], text_mask=batch["text_mask"],
                      text_len=batch["text_len"], padding_mask=~batch["mask"],
                      background=batch["background"])

        def run():
            with torch.inference_mode():
                return G(deterministic=True, **inputs)

        modules = (G,)
    else:
        state = train_state(G, D)
        step = make_train_step(batch_size=b, z_dim=cfg.z_dim, max_elements=cfg.max_elements,
                               share_text_encoder=not args.no_share_text_encoder)
        train_batch = {k: v for k, v in batch.items() if k != "z"}
        n, stats = 0, {}

        def run():
            nonlocal n, stats
            n += 1
            stats = step(state, train_batch, torch.Generator().manual_seed(n))
            return stats

        modules = (G, D)

    flops = count_flops(run, modules)
    source = "derived" if flops else "fallback"
    for _ in range(args.warmup):
        run()
    sync()
    log(f"set-up, FLOP count and warm-up: {time.perf_counter() - t0:.1f} s")

    def window(steps: int) -> float:
        sync()
        start = time.perf_counter()
        for _ in range(steps):
            run()
        sync()
        return time.perf_counter() - start

    with trace(args.profile or "", enabled=args.profile is not None):
        dt_burst = window(args.burst_steps)
        dt_sust = window(args.steps)
    if not args.infer:
        bad = [k for k, v in stats.items() if not torch.isfinite(v).all()]
        if bad:
            raise RuntimeError(f"bench: non-finite train stats {bad}")

    burst_ips = b * args.burst_steps / dt_burst
    sust_ips = b * args.steps / dt_sust
    what = "infer" if args.infer else "train"
    log(f"{what} sustained={sust_ips:.2f} imgs/s ({args.steps} calls, {dt_sust:.3f} s) | "
        f"burst={burst_ips:.2f} ({args.burst_steps} calls, {dt_burst:.3f} s)")
    diag = dict(card=card, dtype=str(dtype)[6:], batch=b, T=t, flops_per_step=flops,
                flops_source=source, peak_tflops=peak,
                calls=dict(flop_count=1, warmup=args.warmup, burst=args.burst_steps,
                           sustained=args.steps))
    if flops:
        achieved = flops * args.steps / dt_sust
        ref_ips = A100_PEAK_FLOPS * REF_ASSUMED_MFU / (flops / b)
        diag.update(flops_per_img=flops / b, achieved_tflops=achieved / 1e12)
        mfu = "MFU not measured (no card)"
        if device.type == "cuda":
            diag["mfu"] = achieved / (peak * 1e12)
            mfu = f"MFU {diag['mfu']:.2%} of {peak:g}"
        vs_jax = "" if args.infer else (f", {flops / b / JAX_TRAIN_FLOPS_PER_IMG:.3f}x JAX's XLA "
                                        f"count {JAX_TRAIN_FLOPS_PER_IMG:.4g} (bf16 T=256)")
        log(f"{what} flops/step={flops:.4e} flops/img={flops / b:.4e}{vs_jax}; achieved "
            f"{achieved / 1e12:.3f} TFLOP/s, {mfu} | derived A100 ref {ref_ips:.2f} imgs/s "
            f"(312 TF x {REF_ASSUMED_MFU:.0%} / counted FLOPs)")
    else:
        ref_ips = FALLBACK_REF_INFER_IMGS_PER_SEC if args.infer else FALLBACK_REF_IMGS_PER_SEC
        log(f"using the fallback reference estimate {ref_ips} imgs/s")
    if device.type == "cuda":
        diag["peak_memory_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
        log(f"peak memory {diag['peak_memory_gib']:.2f} GiB  [{card}]")
    line = {
        "metric": "gan_inference_throughput" if args.infer else "gan_train_step_throughput",
        "value": round(sust_ips, 3),  # sustained (the headline)
        "unit": "imgs/sec/chip",
        "vs_baseline": round(sust_ips / ref_ips, 3),
        "baseline_source": source,
        "value_sustained": round(sust_ips, 3),
        "value_burst": round(burst_ips, 3),
        "vs_baseline_burst": round(burst_ips / ref_ips, 3),
    }
    print(json.dumps(line), flush=True)
    return dict(line=line, **diag)


if __name__ == "__main__":
    main()
