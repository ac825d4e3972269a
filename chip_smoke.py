#!/usr/bin/env python3
"""Run the PyTorch port's layout-inference path on one NVIDIA GPU and
hold every kernel on it against its plain version.

    python3 chip_smoke.py [--seed 0] [--batch 16]

Phases (any failure ends the run with a non-zero exit and no result):

1. device: name and power limit (nvidia-smi);
2. build: the CUDA kernels from the sources in this checkout (nvcc,
   sm_90a), timed;
3. kernels: each kernel vs its plain PyTorch version at the main path's
   shapes (fused_attention: [B*9, 4, T, 192], T in {256, 64}, fp32 and
   bf16, key padding down to length 2), with its time, the plain
   version's, one PyTorch library call's and the card's bound;
4. model: the full-width Generator (GeneratorConfig() defaults) from
   seeded random weights, with the kernel vs with plain attention on the
   card in fp32 and in bf16, the bf16 model vs the fp32 one, and the
   card vs the CPU on a small input;
5. serving (the main path): batches of requests through
   ``generate_layouts`` at T=256 and T=64, fp32 and bf16, with launch
   counts set to 0 before and read after; each forward must launch the
   attention kernel 12 times;
6. forward: each variant's forward alone, outside the counted run: its
   time (CUDA events), then one forward under torch.profiler: device
   time by kernel and the device's idle share.

The last three lines of standard output are the kernels JSON, the card
(nvidia-smi name, power limit) and ``{"ok": true, "device": {...}}``.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data sheet (dense): fp32 on the CUDA cores, bf16 on the tensor
# cores, HBM3 bandwidth.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# Kernel vs plain attention inside the full model, fp32 without TF32: the
# two sum q.k and p.v in another order (~1e-7 relative per layer); 12
# BERT layers, LayerNorms and the DETR stack carry that into bbox_fake
# well below 1e-4.
MODEL_TOL = 1e-4
# The same in bf16: the two models differ only in attention, whose
# outputs may differ by one bf16 rounding (2^-8 relative) since the kernel
# rounds p per 64-key chunk after an online max and the plain version
# after the full softmax. 12 layers of bf16 GEMMs and the DETR stack carry
# that through the sigmoid (slope <= 1/4) into bbox_fake.
MODEL_TOL_BF16 = 2e-2
# The bf16 model with the kernel vs the fp32 plain model: every Dense,
# conv and attention rounds to bf16 (2^-8 relative) through ~100 layers.
# Catches a wrong cast or dtype in the model, which the kernel-vs-plain
# bf16 pair shares and so cannot see.
BF16_VS_FP32_TOL = 5e-2
# The card vs the CPU on one small input: cuDNN and the CPU's conv
# kernels sum in other orders through 16 unnormalized residual blocks.
CPU_TOL = 1e-4
WORDS = ("summer sale up to 50% off shop now free shipping new arrivals limited time only "
         "sign up today exclusive deals best price learn more the ultimate collection").split()
LABELS = ("header", "pre-header", "post-header", "body text", "disclaimer / footnote",
          "button", "callout", "logo")


def log(*args):
    print(*args, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over iters launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_phase(torch, attention, seed: int, batch: int) -> list:
    """Kernel vs plain at the main path's shapes; returns one record per case."""
    import torch.nn.functional as F

    b, h, d = batch * 9, 4, 192
    scale = d ** -0.5
    cases = []
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        esize = torch.finfo(dtype).bits // 8
        for t in (256, 64):
            g = torch.Generator(device="cuda").manual_seed(seed + t)
            # [B, T, H, D] projections viewed as [B, H, T, D], as BERT gives them
            q, k, v = (torch.randn(b, t, h, d, device="cuda", generator=g).to(dtype).transpose(1, 2)
                       for _ in range(3))
            lens = torch.randint(2, t + 1, (b,), device="cuda", generator=g)
            lens[0], lens[1] = 2, t
            bias = torch.where(torch.arange(t, device="cuda")[None] < lens[:, None], 0.0, -10000.0)

            out = attention.fused_attention(q, k, v, bias, scale=scale)
            torch.cuda.synchronize()
            # the plain version in fp32 on the same (bf16-valued) inputs:
            # the bf16 kernel rounds p to bf16 before p.v and rounds its
            # output to bf16; this reference keeps both in fp32
            want = attention.attention_ref(q.float(), k.float(), v.float(), bias, scale)
            torch.cuda.synchronize()
            err = (out.float() - want).abs().max().item()
            if not err <= ATTN_TOL[dtype_name]:
                raise AssertionError(f"fused_attention {dtype_name} T={t}: max-abs {err} "
                                     f"> {ATTN_TOL[dtype_name]}")

            ms = cuda_ms(torch, lambda: attention.fused_attention(q, k, v, bias, scale=scale), 20)
            plain_ms = cuda_ms(torch, lambda: attention.attention_ref(q, k, v, bias, scale), 10)
            mask = bias.to(dtype)[:, None, None, :]
            library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=scale), 20)
            flops = 4.0 * b * h * t * t * d
            nbytes = 4.0 * b * h * t * d * esize + b * t * 4
            t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
            t_bytes = nbytes / PEAK_BYTES * 1e3
            rec = dict(dtype=dtype_name, shape=[b, h, t, d], max_abs_err=err, ms=ms,
                       plain_ms=plain_ms, library_ms=library_ms, bound_ms=max(t_ops, t_bytes),
                       bound_by="operations" if t_ops >= t_bytes else "bytes",
                       gflop=flops / 1e9, mbytes=nbytes / 1e6,
                       tflops=flops / ms / 1e9)
            log(f"fused_attention {dtype_name} {rec['shape']}: max-abs {err:.3e}  kernel "
                f"{ms:.4f} ms ({rec['tflops']:.2f} TFLOP/s)  plain {plain_ms:.4f} ms  "
                f"sdpa {library_ms:.4f} ms  bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
            cases.append(rec)
            del q, k, v, out, want, mask
    return cases


def model_batch(np, cfg, b: int, seed: int, t: int | None = None) -> dict:
    rng = np.random.default_rng(seed)
    n, t = cfg.max_elements, t or cfg.max_text_length
    lens = rng.integers(2, t + 1, size=(b, n))
    lens[0, 0] = 2
    mask = (np.arange(t)[None, None, :] < lens[..., None]).astype(np.int32)
    pad = np.zeros((b, n), bool)
    pad[:, 1:] = rng.random((b, n - 1)) < 0.4
    s = cfg.background_size
    return dict(
        z=rng.normal(size=(b, n, cfg.z_dim)).astype(np.float32),
        bbox_class=rng.integers(0, cfg.num_bbox_labels, size=(b, n)),
        bbox_real=np.zeros((b, n, 4), np.float32),
        text_ids=rng.integers(999, 30522, size=(b, n, t)) * mask,
        text_mask=mask,
        text_len=rng.integers(0, 80, size=(b, n)),
        padding_mask=pad,
        background=rng.normal(size=(b, s, s, 3)).astype(np.float32),
    )


def to_device(torch, batch: dict, device) -> dict:
    out = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    for k in ("bbox_class", "text_ids", "text_len"):
        out[k] = out[k].long()
    return out


def requests(np, cfg, n: int, seed: int):
    from layoutdetr_tpu_torch.generate import LayoutRequest

    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n):
        k = int(rng.integers(1, 10))
        strings = [" ".join(rng.choice(WORDS, size=int(rng.integers(0, 12)))) for _ in range(k)]
        labels = [LABELS[i] for i in rng.integers(0, len(LABELS), size=k)]
        bg = rng.normal(size=(cfg.background_size, cfg.background_size, 3)).astype(np.float32)
        reqs.append(LayoutRequest(bg, strings, labels))
    return reqs


def main() -> int:
    ap = argparse.ArgumentParser(description="Run the port's main path on one GPU.")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=16, help="requests per served batch")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    from layoutdetr_tpu_torch.config import GeneratorConfig
    from layoutdetr_tpu_torch.generate import generate_layouts
    from layoutdetr_tpu_torch.models.generator import Generator
    from layoutdetr_tpu_torch.ops import _build, attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. device
    card = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} | nvidia-smi: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    lib = _build.build("attention")
    build_s = time.perf_counter() - t0
    log(f"build attention.cu: {build_s:.2f} s -> {os.path.relpath(lib, ROOT)}")
    with open(lib + ".log") as f:
        log(f.read().strip())

    # 3. kernels vs plain
    attn_cases = attention_phase(torch, attention, args.seed, args.batch)

    # 4. full-width model: kernel vs plain attention (fp32, bf16), bf16 vs
    # fp32, card vs CPU
    cfg = GeneratorConfig()
    torch.manual_seed(args.seed)
    with torch.device("cuda"):
        model = Generator(cfg).eval()
    state = model.state_dict()
    with torch.device("cuda"):
        plain = Generator(cfg, flash_attention=False).eval()
    plain.load_state_dict(state, strict=True)
    batch = to_device(torch, model_batch(np, cfg, args.batch, args.seed), "cuda")
    with torch.inference_mode():
        got = model(**batch)
        torch.cuda.synchronize()
        want = plain(**batch)
    err = (got - want).abs().max().item()
    if got.shape != (args.batch, 9, 4) or not torch.isfinite(got).all() or not err <= MODEL_TOL:
        raise AssertionError(f"Generator kernel vs plain: shape {tuple(got.shape)}, max-abs {err}")
    log(f"Generator fp32 B={args.batch} T=256, kernel vs plain attention: bbox_fake max-abs {err:.3e}")
    del plain

    with torch.device("cuda"):
        bf16 = Generator(cfg, dtype=torch.bfloat16).eval()
        bf16_plain = Generator(cfg, dtype=torch.bfloat16, flash_attention=False).eval()
    bf16.load_state_dict(state, strict=True)
    bf16_plain.load_state_dict(state, strict=True)
    with torch.inference_mode():
        got = bf16(**batch)
        torch.cuda.synchronize()
        want16 = bf16_plain(**batch)
    err_bf16 = (got - want16).abs().max().item()
    err_bf16_fp32 = (got - want).abs().max().item()
    log(f"Generator bf16 B={args.batch} T=256: bbox_fake max-abs {err_bf16:.3e} kernel vs plain "
        f"attention (bf16), {err_bf16_fp32:.3e} vs the fp32 plain model")
    if (got.dtype != torch.float32 or got.shape != want.shape or not torch.isfinite(got).all()
            or not err_bf16 <= MODEL_TOL_BF16 or not err_bf16_fp32 <= BF16_VS_FP32_TOL):
        raise AssertionError(f"bf16 Generator: {got.dtype} {tuple(got.shape)}, max-abs "
                             f"{err_bf16} vs bf16 plain, {err_bf16_fp32} vs fp32 plain")
    del bf16, bf16_plain

    small = model_batch(np, cfg, 1, args.seed + 1, t=64)
    cpu_model = Generator(cfg).eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in state.items()}, strict=True)
    with torch.inference_mode():
        got = model(**to_device(torch, small, "cuda")).cpu()
        want = cpu_model(**to_device(torch, small, "cpu"))
    err_cpu = (got - want).abs().max().item()
    if not err_cpu <= CPU_TOL:
        raise AssertionError(f"Generator card vs CPU: max-abs {err_cpu}")
    log(f"Generator fp32 B=1 T=64, card vs CPU: bbox_fake max-abs {err_cpu:.3e}")
    del cpu_model

    # 5. serving, the main path: counts from 0, read right after
    reqs = requests(np, cfg, args.batch, args.seed)
    variants = []
    for dtype_name in ("float32", "bfloat16"):
        for t in (256, 64):
            vcfg = dataclasses.replace(cfg, max_text_length=t, text_len_table=256)
            with torch.device("cuda"):
                m = Generator(vcfg, dtype=getattr(torch, dtype_name))
            m.load_state_dict(state, strict=True)
            variants.append((dtype_name, t, m.eval()))
    del model
    serving = []
    attention.fused_attention.launches = 0
    forwards = 0
    for dtype_name, t, m in variants:
        e2e = []
        for i in range(6):  # the first batch warms up
            before = attention.fused_attention.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            layouts = generate_layouts(m, reqs, seed=args.seed + i, device="cuda")
            torch.cuda.synchronize()
            e2e.append(time.perf_counter() - t0)
            forwards += 1
            n = attention.fused_attention.launches - before
            if n != cfg.bert_num_encoder_layers:
                raise AssertionError(f"{n} attention launches in one forward, expected 12")
            for lay in layouts:
                if not np.isfinite(lay.bbox).all() or not ((lay.raw > 0) & (lay.raw < 1)).all():
                    raise AssertionError(f"served layout out of range: {lay.raw}")
        e2e_s = sum(e2e[1:]) / len(e2e[1:])
        rec = dict(dtype=dtype_name, T=t, batch=args.batch, requests_per_s=args.batch / e2e_s,
                   request_batch_ms=1e3 * e2e_s)
        serving.append(rec)
        log(f"serving {dtype_name} T={t} batch {args.batch}: {rec['requests_per_s']:.1f} requests/s "
            f"end to end ({rec['request_batch_ms']:.1f} ms a batch)  [{card}]")
    launches = attention.fused_attention.launches
    if launches != forwards * cfg.bert_num_encoder_layers:
        raise AssertionError(f"attention launched {launches} times in {forwards} forwards")
    log(f"main path: {forwards} served batches, fused_attention launched {launches} times")

    # 6. the forward alone, outside the counted run: time and device profile
    forward_phase(torch, variants, serving, np, args, card)

    head = next(c for c in attn_cases if c["dtype"] == "float32" and c["shape"][2] == 256)
    kernels = [dict(name="fused_attention", route="cuda",
                    source="layoutdetr_tpu_torch/ops/csrc/attention.cu",
                    replaces="layoutdetr_tpu/ops/attention.py:98", launches=launches,
                    max_abs_err=head["max_abs_err"], ms=head["ms"], plain_ms=head["plain_ms"],
                    bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                    library_ms=head["library_ms"], cases=attn_cases)]
    log(json.dumps({"serving": serving, "model_max_abs": err, "model_bf16_max_abs": err_bf16,
                    "model_bf16_vs_fp32_max_abs": err_bf16_fp32, "cpu_max_abs": err_cpu,
                    "build_s": build_s,
                    "wall_s": time.perf_counter() - t_start}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


def forward_phase(torch, variants, serving, np, args, card):
    """Per variant: forward time over 5 back-to-back forwards (CUDA events),
    then one profiled forward: device-busy time by kernel, and the device's
    idle share of the unprofiled forward time."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    for (dtype_name, t, m), rec in zip(variants, serving):
        inputs = to_device(torch, model_batch(np, m.cfg, args.batch, args.seed), "cuda")
        with torch.inference_mode():
            fwd_ms = cuda_ms(torch, lambda: m(**inputs), 5, warmup=1)
            rec.update(forward_ms=fwd_ms, images_per_s=args.batch / fwd_ms * 1e3)
            log(f"forward {dtype_name} T={t} batch {args.batch}: {fwd_ms:.1f} ms = "
                f"{rec['images_per_s']:.1f} images/s  [{card}]")
            with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                m(**inputs)
                torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        rec.update(device_busy_ms=busy_ms, idle_share=1.0 - busy_ms / fwd_ms,
                   kernel_launches=sum(e.count for e in events))
        log(f"profile {dtype_name} T={t} B={args.batch}: device busy {busy_ms:.2f} ms of a "
            f"{rec['forward_ms']:.2f} ms forward (idle share {rec['idle_share']:.3f}), "
            f"{rec['kernel_launches']} kernel launches")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
            log(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  {e.key[:100]}")


if __name__ == "__main__":
    sys.exit(main())
