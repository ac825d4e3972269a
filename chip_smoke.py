#!/usr/bin/env python3
"""Run the PyTorch port's main paths on one NVIDIA GPU and hold every
kernel on them against its plain version.

    python3 chip_smoke.py [--seed 0] [--batch 16]

Phases (any failure ends the run with a non-zero exit and no result):

1. device: name and power limit (nvidia-smi);
2. build: the CUDA kernels from the sources in this checkout (nvcc,
   sm_90a), one nvcc per source, all started together, timed;
3. kernels: each kernel vs its plain PyTorch version at the main paths'
   shapes, with its time, the plain version's, one PyTorch library call's
   and the card's bound:
   - fused_attention [B*9, 4, T, 192], T in {256, 64}, fp32 and bf16, key
     padding down to length 2; deterministic, and with dropout 0.1 against
     the plain version with the same Philox keep mask;
   - bias_act forward and backward at every distinct shape of the train
     step's 48 calls (D's bg_decoder at batch 16), fp32 and bf16;
4. model: the full-width Generator (GeneratorConfig() defaults) from
   seeded random weights, with the kernel vs with plain attention on the
   card in fp32 and in bf16, the bf16 model vs the fp32 one, and the
   card vs the CPU on a small input;
5. serving (slice 1's main path): batches of requests through
   ``generate_layouts`` at T=256 and T=64, fp32 and bf16, with launch
   counts set to 0 before and read after; each forward must launch the
   attention kernel 12 times;
6. forward: each serving variant's forward alone, outside the counted
   run: its time (CUDA events), then one forward under torch.profiler;
7. train step (slice 2's main path): full-width G and D from seeded
   random weights, batch 16, dropout on, the shared hoisted text pass, in
   bf16 T=256, fp32 T=256 and bf16 T=64; per variant 1 warm-up, 3 timed
   and 1 profiled step with the launch counts set to 0 before and read
   after (12 attention, 48 bias_act forward and 48 backward launches a
   step); finite losses, trainable parameters moved, frozen ones not;
   step time, images/s, peak memory, device busy time, idle share and the
   split between the text pass, Gmain, Dmain, Adam and EMA;
8. step correctness: one deterministic full-width fp32 step with the
   kernels vs with the plain versions, and one small full-width step
   (B=2, T=64) on the card vs on the CPU.

The last three lines of standard output are the kernels JSON, the card
(nvidia-smi name, power limit) and ``{"ok": true, "device": {...}}``.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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
# bias_act vs its plain version on the same inputs. fp32 forward and dx:
# the same elementwise fp32 arithmetic (exp/tanh may differ by an ulp),
# 1e-6 of max |y|. fp32 db: a sum over up to 1M positions in another
# order, 1e-5 of max |db|. bf16: the kernel computes in fp32 and rounds
# once, so it lies within one bf16 rounding (2^-8) of the fp32 plain
# version of the same bf16 inputs.
BIAS_ACT_TOL = {"float32": (1e-6, 1e-5), "bfloat16": (2 ** -8, 2 ** -8)}
# One train step, kernels vs plain versions (and card vs CPU), fp32,
# deterministic, same weights and z. Losses: the two differ in the order
# of sums inside attention, bias_act's db and (card vs CPU) every GEMM and
# conv, and cuDNN's backward sums with atomics; through ~100 layers that
# stays below 1e-4 relative. Parameters after one Adam step: with beta1 = 0
# the first update is lr * g / (|g| + eps) ~ +-lr, so where a gradient is
# within rounding noise of 0 its sign, and the update, may flip: within
# 2 * lr_eff everywhere (plus 1% for the fp32 rounding of p -+ lr_eff
# itself), and entries more than 1e-6 off under 1% (the CPU tests of the
# port against JAX see 0.0008%).
STEP_LOSS_TOL = 1e-4
STEP_FLIP_SHARE = 1e-2
LR_EFF = {"G": 1e-5 * 4 / 5, "D": 1e-5 * 16 / 17}
DROPOUT = 0.1
KEPT_TOL = 1e-3
WORDS = ("summer sale up to 50% off shop now free shipping new arrivals limited time only "
         "sign up today exclusive deals best price learn more the ultimate collection").split()
LABELS = ("header", "pre-header", "post-header", "body text", "disclaimer / footnote",
          "button", "callout", "logo")
TRAIN_VARIANTS = (("bfloat16", 256), ("float32", 256), ("bfloat16", 64))
RANGES = ("train_step.", "Optimizer.")  # profiler range names, not kernels


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


def bound(flops: float, nbytes: float, dtype_name: str):
    """(bound ms, "operations" or "bytes") on this card's published peaks."""
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


# ---------------------------------------------------------------------------
# 3. kernels vs plain
# ---------------------------------------------------------------------------

def attention_phase(torch, attention, seed: int, batch: int) -> list:
    """Kernel vs plain at the main paths' shapes, without and with dropout;
    returns one record per case."""
    import torch.nn.functional as F

    b, h, d = batch * 9, 4, 192
    scale = d ** -0.5
    cases = []
    for rate in (0.0, DROPOUT):
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            esize = torch.finfo(dtype).bits // 8
            for t in (256, 64):
                g = torch.Generator(device="cuda").manual_seed(seed + t)
                # [B, T, H, D] projections viewed as [B, H, T, D], as BERT gives them
                q, k, v = (torch.randn(b, t, h, d, device="cuda", generator=g).to(dtype)
                           .transpose(1, 2) for _ in range(3))
                lens = torch.randint(2, t + 1, (b,), device="cuda", generator=g)
                lens[0], lens[1] = 2, t
                bias = torch.where(torch.arange(t, device="cuda")[None] < lens[:, None], 0.0, -10000.0)
                drop = dict(dropout_rate=rate, seed=seed + 7 if rate else None)

                out = attention.fused_attention(q, k, v, bias, scale=scale, **drop)
                torch.cuda.synchronize()
                mask = attention.keep_mask(seed + 7, b, h, t, rate, device="cuda") if rate else None
                # the plain version in fp32 on the same (bf16-valued) inputs and
                # the same keep mask: the bf16 kernel rounds p to bf16 before
                # p.v and rounds its output to bf16; this reference keeps both
                # in fp32
                want = attention.attention_ref(q.float(), k.float(), v.float(), bias, scale, rate, mask)
                torch.cuda.synchronize()
                err = (out.float() - want).abs().max().item()
                # with dropout, outputs grow by up to 1 / (1 - rate) and so does
                # their bf16 spacing: the bar follows max |o| / 4 above 4
                tol = ATTN_TOL[dtype_name] * (max(1.0, want.abs().max().item() / 4.0) if rate else 1.0)
                if not err <= tol:
                    raise AssertionError(f"fused_attention {dtype_name} T={t} rate={rate}: "
                                         f"max-abs {err} > {tol}")
                kept = mask.float().mean().item() if rate else 1.0
                if rate and not abs(kept - (1.0 - rate)) <= KEPT_TOL:
                    raise AssertionError(f"kept fraction {kept}, expected {1 - rate} +- {KEPT_TOL}")

                ms = cuda_ms(torch, lambda: attention.fused_attention(q, k, v, bias, scale=scale,
                                                                      **drop), 20)

                def plain():
                    m = attention.keep_mask(seed + 7, b, h, t, rate, device="cuda") if rate else None
                    return attention.attention_ref(q, k, v, bias, scale, rate, m)

                plain_ms = cuda_ms(torch, plain, 5)
                amask = bias.to(dtype)[:, None, None, :]
                library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=amask, scale=scale, dropout_p=rate), 20)
                flops = 4.0 * b * h * t * t * d
                nbytes = 4.0 * b * h * t * d * esize + b * t * 4
                bound_ms, bound_by = bound(flops, nbytes, dtype_name)
                rec = dict(dtype=dtype_name, shape=[b, h, t, d], dropout_rate=rate, max_abs_err=err,
                           tol=tol, kept_fraction=kept, ms=ms, plain_ms=plain_ms,
                           library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                           gflop=flops / 1e9, mbytes=nbytes / 1e6, tflops=flops / ms / 1e9)
                log(f"fused_attention {dtype_name} {rec['shape']} dropout {rate}: max-abs {err:.3e} "
                    f"(bar {tol:.3e}), kept {kept:.5f}  kernel {ms:.4f} ms ({rec['tflops']:.2f} "
                    f"TFLOP/s)  plain {plain_ms:.4f} ms  sdpa {library_ms:.4f} ms  bound "
                    f"{bound_ms:.4f} ms ({bound_by})")
                cases.append(rec)
                del q, k, v, out, want, mask, amask
    return cases


@contextlib.contextmanager
def recorded_bias_act_calls(bias_act_mod, calls: list):
    """Record the arguments of every bias_act forward launched inside."""
    real = bias_act_mod.bias_act_forward

    def record(x, b, dim, act, alpha, gain, clamp):
        calls.append((tuple(x.shape), dim, act, alpha, gain, clamp))
        return real(x, b, dim, act, alpha, gain, clamp)

    bias_act_mod.bias_act_forward = record
    try:
        yield
    finally:
        bias_act_mod.bias_act_forward = real


@contextlib.contextmanager
def plain_bias_act(bias_act_mod):
    """Inside, the bias_act Function runs its plain versions on the card
    (the comparison of a whole step with and without the kernels)."""
    fwd, bwd = bias_act_mod.bias_act_forward, bias_act_mod.bias_act_backward
    bias_act_mod.bias_act_forward = bias_act_mod.bias_act_ref
    bias_act_mod.bias_act_backward = bias_act_mod.bias_act_ref_backward
    try:
        yield
    finally:
        bias_act_mod.bias_act_forward, bias_act_mod.bias_act_backward = fwd, bwd


def bias_act_phase(torch, bias_act_mod, calls: list, seed: int) -> list:
    """Forward and backward kernels vs the plain versions at each distinct
    call of one step's bg_decoder forward; one record per (call, dtype)
    with the number of times a step makes that call."""
    distinct = {}
    for c in calls:
        distinct[c] = distinct.get(c, 0) + 1
    records = []
    for (shape, dim, act, alpha, gain, clamp), per_step in distinct.items():
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            es = torch.finfo(dtype).bits // 8
            g = torch.Generator(device="cuda").manual_seed(seed)
            x = torch.randn(shape, device="cuda", generator=g).to(dtype)
            b = torch.randn(shape[dim], device="cuda", generator=g)
            dy = torch.randn(shape, device="cuda", generator=g).to(dtype)
            args = (dim, act, alpha, gain, clamp)
            y = bias_act_mod.bias_act_forward(x, b, *args)
            dx, db = bias_act_mod.bias_act_backward(dy, x, b, *args)
            torch.cuda.synchronize()
            want_y = bias_act_mod.bias_act_ref(x.float(), b, *args)
            want_dx, want_db = bias_act_mod.bias_act_ref_backward(dy.float(), x.float(), b, *args)
            tol_y, tol_db = BIAS_ACT_TOL[dtype_name]
            errs = dict(
                y=(y.float() - want_y).abs().max().item() / max(want_y.abs().max().item(), 1e-30),
                dx=(dx.float() - want_dx).abs().max().item() / max(want_dx.abs().max().item(), 1e-30),
                db=(db - want_db).abs().max().item() / max(want_db.abs().max().item(), 1e-30))
            if not (errs["y"] <= tol_y and errs["dx"] <= tol_y and errs["db"] <= tol_db):
                raise AssertionError(f"bias_act {dtype_name} {shape} {act}: relative errors {errs}")
            n = math.prod(shape)
            fwd_ms = cuda_ms(torch, lambda: bias_act_mod.bias_act_forward(x, b, *args), 20)
            bwd_ms = cuda_ms(torch, lambda: bias_act_mod.bias_act_backward(dy, x, b, *args), 20)
            plain_fwd = cuda_ms(torch, lambda: bias_act_mod.bias_act_ref(x, b, *args), 10)
            plain_bwd = cuda_ms(torch, lambda: bias_act_mod.bias_act_ref_backward(dy, x, b, *args), 10)
            # the eager two-call form a user would write (x + b, then the act
            # with its gain), a labelled extra: for lrelu no single PyTorch call
            # fuses it
            bview = b.to(dtype).view([-1 if i == dim else 1 for i in range(len(shape))])
            if act == "lrelu":
                two_call = lambda: torch.nn.functional.leaky_relu(x + bview, alpha) * gain
            else:
                two_call = lambda: (x + bview) * gain
            eager_ms = cuda_ms(torch, two_call, 10)
            # where the call is linear with gain 1 and no clamp (the affine FCs
            # and ToRGB, 27 of the 48), one PyTorch call computes the same
            # function: the forward is torch.add(x, b) (b in x's dtype), the
            # backward's db one sum of dy (dx is dy itself). The lrelu calls
            # have no such call.
            lib_fwd = lib_bwd = lib_err = None
            if act == "linear" and gain == 1.0 and clamp is None:
                others = [i for i in range(len(shape)) if i != dim]
                lib_err = ((torch.add(x, bview).float() - want_y).abs().max().item()
                           / max(want_y.abs().max().item(), 1e-30))
                if dtype_name == "float32" and not lib_err <= tol_y:  # the same fp32 add
                    raise AssertionError(f"torch.add vs bias_act_ref {shape}: {lib_err}")
                lib_fwd = cuda_ms(torch, lambda: torch.add(x, bview), 20)
                lib_bwd = cuda_ms(torch, lambda: torch.sum(dy, dim=others, dtype=torch.float32), 20)
            # ~4 operations an element forward (add, act, gain, clamp), ~6 backward
            fb, fby = bound(4.0 * n, 2.0 * n * es + 4 * shape[dim], "float32")
            bb, bby = bound(6.0 * n, 3.0 * n * es + 8 * shape[dim], "float32")
            rec = dict(dtype=dtype_name, shape=list(shape), act=act, gain=gain, per_step=per_step,
                       rel_err=errs, fwd_ms=fwd_ms, bwd_ms=bwd_ms, plain_fwd_ms=plain_fwd,
                       plain_bwd_ms=plain_bwd, eager_two_call_ms=eager_ms, library_fwd_ms=lib_fwd,
                       library_bwd_ms=lib_bwd, library_rel_err=lib_err, fwd_bound_ms=fb,
                       fwd_bound_by=fby, bwd_bound_ms=bb, bwd_bound_by=bby)
            lib = ("none" if lib_fwd is None else
                   f"torch.add {lib_fwd:.4f} / torch.sum {lib_bwd:.4f}")
            log(f"bias_act {dtype_name} {list(shape)} {act} x{per_step}/step: rel err y "
                f"{errs['y']:.2e} dx {errs['dx']:.2e} db {errs['db']:.2e}  fwd {fwd_ms:.4f} ms "
                f"(plain {plain_fwd:.4f}, two-call {eager_ms:.4f}, bound {fb:.4f} {fby})  bwd "
                f"{bwd_ms:.4f} ms (plain {plain_bwd:.4f}, bound {bb:.4f} {bby})  library {lib}")
            records.append(rec)
            del x, b, dy, y, dx, db, want_y, want_dx, want_db
    return records


def per_step_totals(records: list, dtype_name: str) -> dict:
    """Sums over one step's calls (each distinct call times its count);
    library_* and *_ms_library_calls sum only the calls that have a library
    call (library_calls of them), the kernel's time beside the library's."""
    out = dict(fwd_ms=0.0, bwd_ms=0.0, plain_fwd_ms=0.0, plain_bwd_ms=0.0, fwd_bound_ms=0.0,
               bwd_bound_ms=0.0, max_rel_err_fwd=0.0, max_rel_err_bwd=0.0, library_fwd_ms=0.0,
               library_bwd_ms=0.0, fwd_ms_library_calls=0.0, bwd_ms_library_calls=0.0,
               library_calls=0)
    for r in records:
        if r["dtype"] != dtype_name:
            continue
        for k in ("fwd_ms", "bwd_ms", "plain_fwd_ms", "plain_bwd_ms", "fwd_bound_ms", "bwd_bound_ms"):
            out[k] += r[k] * r["per_step"]
        if r["library_fwd_ms"] is not None:
            out["library_calls"] += r["per_step"]
            for key in ("fwd", "bwd"):
                out[f"library_{key}_ms"] += r[f"library_{key}_ms"] * r["per_step"]
                out[f"{key}_ms_library_calls"] += r[f"{key}_ms"] * r["per_step"]
        out["max_rel_err_fwd"] = max(out["max_rel_err_fwd"], r["rel_err"]["y"])
        out["max_rel_err_bwd"] = max(out["max_rel_err_bwd"], r["rel_err"]["dx"], r["rel_err"]["db"])
    return out


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

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
        bbox_real=rng.uniform(0.1, 0.9, size=(b, n, 4)).astype(np.float32),
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


def train_batch(torch, np, cfg, b: int, seed: int, device, t: int | None = None) -> dict:
    """A batch in the train step's format (bench.py's keys)."""
    m = to_device(torch, model_batch(np, cfg, b, seed, t), device)
    return dict(bboxes=m["bbox_real"], labels=m["bbox_class"], text_ids=m["text_ids"],
                text_mask=m["text_mask"], text_len=m["text_len"], mask=~m["padding_mask"],
                background=m["background"])


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


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def new_train_state(torch, cfg, dtype, states, device, flash_attention=True):
    """G, D (from the state dicts ``states``), optimizers and G_ema;
    ``flash_attention=False`` builds G with plain attention (D's text
    encoder never runs: the step hands D the hoisted text features)."""
    from layoutdetr_tpu_torch.models.discriminator import Discriminator
    from layoutdetr_tpu_torch.models.generator import Generator
    from layoutdetr_tpu_torch.training.optimizers import build_optimizer
    from layoutdetr_tpu_torch.training.train_step import GANTrainState

    with torch.device(device):
        G = Generator(cfg, dtype=dtype, flash_attention=flash_attention)
        D = Discriminator(cfg, dtype=dtype)
    G.load_state_dict(states[0], strict=True)
    D.load_state_dict(states[1], strict=True)
    opt_g = build_optimizer(G.train(), reg_interval=4)
    opt_d = build_optimizer(D.train(), reg_interval=16)
    return GANTrainState.create(G, D, opt_g, opt_d)


def make_step(cfg, batch_size: int, deterministic: bool):
    from layoutdetr_tpu_torch.training.train_step import make_train_step

    return make_train_step(batch_size=batch_size, z_dim=cfg.z_dim, max_elements=cfg.max_elements,
                           deterministic=deterministic)


def counters(attention, bias_act_mod):
    return (attention.LAUNCHES["fused_attention"], bias_act_mod.LAUNCHES["forward"],
            bias_act_mod.LAUNCHES["backward"])


def zero_counters(attention, bias_act_mod):
    attention.LAUNCHES["fused_attention"] = 0
    bias_act_mod.LAUNCHES.update(forward=0, backward=0)


def profile_summary(prof, wall_ms: float) -> dict:
    """Device busy ms (kernels and copies, without the profiler's range
    entries), idle share, launches, the largest kernels, and per
    train_step.<part> range its host time and its device span (first
    kernel start to last kernel end, idle gaps included)."""
    averages = prof.key_averages()
    events = [e for e in averages if e.device_type.name == "CUDA"]
    # ranges (train_step.<part>, torch's Optimizer.step#...) also appear as
    # device entries that span their kernels: they are not device work
    kernels = [e for e in events if not e.key.startswith(RANGES)]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    split = {}
    for e in averages:  # a range appears as a host entry and as a device entry
        if e.key.startswith("train_step."):
            part = split.setdefault(e.key[len("train_step."):], dict(host_ms=0.0, device_span_ms=0.0))
            if e.device_type.name == "CUDA":
                part["device_span_ms"] = max(part["device_span_ms"], e.device_time_total / 1e3)
            else:
                part["host_ms"] = max(part["host_ms"], e.cpu_time_total / 1e3)
    host = [e for e in averages if e.device_type.name == "CPU" and not e.key.startswith(RANGES)]
    return dict(device_busy_ms=busy_ms, idle_share=1.0 - busy_ms / wall_ms,
                kernel_launches=sum(e.count for e in kernels),
                top=[(e.key[:90], e.self_device_time_total / 1e3, e.count)
                     for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]],
                top_host=[(e.key[:60], e.self_cpu_time_total / 1e3, e.count)
                          for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:10]],
                split=split)


def train_phase(torch, np, cfg, states, args, card, attention, bias_act_mod) -> list:
    """The main path of slice 2: per variant, counts from 0, 1 warm-up, 3
    timed and 1 profiled step, counts read after."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    results = []
    for dtype_name, t in TRAIN_VARIANTS:
        vcfg = dataclasses.replace(cfg, max_text_length=t, text_len_table=256)
        state = new_train_state(torch, vcfg, getattr(torch, dtype_name), states, "cuda")
        batch = train_batch(torch, np, vcfg, args.batch, args.seed, "cuda")
        step = make_step(vcfg, args.batch, deterministic=False)
        gen = torch.Generator().manual_seed(args.seed)
        before = {f"{m}.{n}": p.detach().clone()
                  for m, mod in (("G", state.G), ("D", state.D)) for n, p in mod.named_parameters()}
        frozen = {f"{m}.{n}" for m, mod in (("G", state.G), ("D", state.D))
                  for n, p in mod.named_parameters() if not p.requires_grad}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        zero_counters(attention, bias_act_mod)
        stats_seen = []
        stats_seen.append(step(state, batch, gen))  # warm-up
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            stats_seen.append(step(state, batch, gen))
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            stats_seen.append(step(state, batch, gen))
            torch.cuda.synchronize()
            prof_wall_ms = (time.perf_counter() - t0) * 1e3
        n_attn, n_fwd, n_bwd = counters(attention, bias_act_mod)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        steps = 5
        if (n_attn, n_fwd, n_bwd) != (12 * steps, 48 * steps, 48 * steps):
            raise AssertionError(f"train {dtype_name} T={t}: {n_attn} attention, {n_fwd} bias_act "
                                 f"forward, {n_bwd} backward launches in {steps} steps")
        for stats in stats_seen:
            bad = [k for k, v in stats.items() if not math.isfinite(float(v))]
            if bad:
                raise AssertionError(f"train {dtype_name} T={t}: non-finite {bad}")
        after = {f"{m}.{n}": p.detach()
                 for m, mod in (("G", state.G), ("D", state.D)) for n, p in mod.named_parameters()}
        moved = {k for k in before if not torch.equal(before[k], after[k])}
        if moved & frozen or not frozen:
            raise AssertionError(f"frozen parameters moved: {sorted(moved & frozen)[:5]}")
        # never run (mode='text'), or a gradient that is 0 but for rounding
        # (softmax ignores a per-row constant: the attention key biases)
        unmoved = sorted(k for k in before if k not in frozen and k not in moved
                         and ".crossattention." not in k and not k.endswith(".key.bias"))
        if unmoved:
            raise AssertionError(f"trainable parameters that did not move: {unmoved[:8]}")
        del before

        step_ms = sorted(times)[len(times) // 2]  # the median: one step may stall on the host
        prof_rec = profile_summary(prof, prof_wall_ms)
        rec = dict(dtype=dtype_name, T=t, batch=args.batch, step_ms=step_ms, step_ms_runs=times,
                   images_per_s=args.batch / step_ms * 1e3, peak_memory_gb=peak_gb,
                   launches_per_step=dict(fused_attention=n_attn // steps,
                                          bias_act=n_fwd // steps, bias_act_backward=n_bwd // steps),
                   launches=dict(fused_attention=n_attn, bias_act=n_fwd, bias_act_backward=n_bwd),
                   profiled_step_wall_ms=prof_wall_ms, **{k: v for k, v in prof_rec.items()
                                                          if k not in ("top", "top_host")},
                   losses={k: float(v) for k, v in stats_seen[-1].items()})
        log(f"train {dtype_name} T={t} batch {args.batch}: step {step_ms:.1f} ms (median) "
            f"(runs {', '.join(f'{x:.1f}' for x in times)}) = {rec['images_per_s']:.1f} images/s, "
            f"peak memory {peak_gb:.2f} GB  [{card}]")
        log(f"  launches per step: {rec['launches_per_step']}; trainable moved, frozen "
            f"({len(frozen)}) unchanged; losses finite")
        log(f"  profiled step: device busy {prof_rec['device_busy_ms']:.1f} ms of "
            f"{prof_wall_ms:.1f} ms (idle share {prof_rec['idle_share']:.3f}), "
            f"{prof_rec['kernel_launches']} kernel launches")
        for part, v in prof_rec["split"].items():
            log(f"    {part:7s} host {v['host_ms']:9.2f} ms   device span {v['device_span_ms']:9.2f} ms")
        log("  largest kernels (device ms):")
        for name, ms, count in prof_rec["top"]:
            log(f"    {ms:9.3f} ms {count:6d}x  {name}")
        log("  largest host ops (self host ms, profiled):")
        for name, ms, count in prof_rec["top_host"]:
            log(f"    {ms:9.3f} ms {count:6d}x  {name}")
        results.append(rec)
        del state, batch, step, prof
        torch.cuda.empty_cache()
    return results


def compare_steps(torch, got: dict, want: dict, what: str) -> dict:
    """Stats and parameters after one step, against another run's."""
    worst_loss = 0.0
    for k, v in want["stats"].items():
        err = abs(got["stats"][k] - v) / max(abs(v), 1.0)
        worst_loss = max(worst_loss, err)
        if not err <= STEP_LOSS_TOL:
            raise AssertionError(f"{what}: {k} {got['stats'][k]} vs {v}")
    out = dict(loss_max_rel=worst_loss)
    for m in ("G", "D"):
        worst, off, total = 0.0, 0, 0
        for name, w in want[m].items():
            if ".crossattention." in name:
                continue
            diff = (got[m][name].float() - w.float()).abs()
            worst = max(worst, diff.max().item())
            off += int((diff > 1e-6).sum())
            total += diff.numel()
        out[m] = dict(max_abs=worst, share_off=off / total)
        if not (worst <= 2.02 * LR_EFF[m] and off <= STEP_FLIP_SHARE * total):
            raise AssertionError(f"{what}: params_{m} max-abs {worst}, {off} of {total} off")
    return out


def one_step(torch, np, cfg, states, batch_size: int, t: int, seed: int, device,
             flash_attention=True) -> dict:
    """One deterministic fp32 step from ``states`` with a fixed z; the
    stats and the parameters after it (on the CPU)."""
    vcfg = dataclasses.replace(cfg, max_text_length=t, text_len_table=256)
    state = new_train_state(torch, vcfg, torch.float32, states, device, flash_attention)
    batch = train_batch(torch, np, vcfg, batch_size, seed, device)
    zg = np.random.default_rng(seed + 11).normal(size=(2, batch_size, 9, vcfg.z_dim))
    z = tuple(torch.from_numpy(x.astype(np.float32)).to(device) for x in zg)
    stats = make_step(vcfg, batch_size, deterministic=True)(state, batch, torch.Generator(), z=z)
    out = dict(stats={k: float(v) for k, v in stats.items()},
               G={k: v.detach().cpu() for k, v in state.G.state_dict().items()},
               D={k: v.detach().cpu() for k, v in state.D.state_dict().items()})
    del state, batch
    return out


def step_correctness_phase(torch, np, cfg, states, args, attention, bias_act_mod) -> dict:
    """Kernels vs plain versions on the card (B=batch, T=256), and the card
    vs the CPU (B=2, T=64), one deterministic fp32 step each."""
    kern = one_step(torch, np, cfg, states, args.batch, 256, args.seed, "cuda")
    torch.cuda.empty_cache()
    n0 = counters(attention, bias_act_mod)
    with plain_bias_act(bias_act_mod):  # and plain attention in G: flash_attention off
        plain = one_step(torch, np, cfg, states, args.batch, 256, args.seed, "cuda",
                         flash_attention=False)
    if counters(attention, bias_act_mod) != n0:
        raise AssertionError("the plain step launched a kernel")
    torch.cuda.empty_cache()
    kv = compare_steps(torch, kern, plain, "step kernels vs plain")
    log(f"step fp32 B={args.batch} T=256, kernels vs plain versions: losses max rel "
        f"{kv['loss_max_rel']:.3e}; params_g max-abs {kv['G']['max_abs']:.3e} "
        f"({kv['G']['share_off']:.2e} off > 1e-6), params_d max-abs {kv['D']['max_abs']:.3e} "
        f"({kv['D']['share_off']:.2e} off)")
    del kern, plain

    card = one_step(torch, np, cfg, states, 2, 64, args.seed + 1, "cuda")
    torch.cuda.empty_cache()
    cpu = one_step(torch, np, cfg, [{k: v.cpu() for k, v in s.items()} for s in states], 2, 64,
                   args.seed + 1, "cpu")
    cv = compare_steps(torch, card, cpu, "step card vs CPU")
    log(f"step fp32 B=2 T=64, card vs CPU: losses max rel {cv['loss_max_rel']:.3e}; params_g "
        f"max-abs {cv['G']['max_abs']:.3e} ({cv['G']['share_off']:.2e} off), params_d max-abs "
        f"{cv['D']['max_abs']:.3e} ({cv['D']['share_off']:.2e} off)")
    return dict(kernels_vs_plain=kv, card_vs_cpu=cv)


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description="Run the port's main paths on one GPU.")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=16, help="requests per served batch, train batch")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    from layoutdetr_tpu_torch.config import GeneratorConfig
    from layoutdetr_tpu_torch.generate import generate_layouts
    from layoutdetr_tpu_torch.models.discriminator import Discriminator
    from layoutdetr_tpu_torch.models.generator import Generator
    from layoutdetr_tpu_torch.ops import _build, attention
    from layoutdetr_tpu_torch.ops import bias_act as bias_act_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. device
    card = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} | nvidia-smi: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build: one nvcc per source, started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        libs = list(pool.map(_build.build, ("attention", "bias_act")))
    build_s = time.perf_counter() - t0
    log(f"build attention.cu + bias_act.cu: {build_s:.2f} s")
    for lib in libs:
        with open(lib + ".log") as f:
            log(f.read().strip())

    # 3. kernels vs plain
    attn_cases = attention_phase(torch, attention, args.seed, args.batch)
    cfg = GeneratorConfig()
    torch.manual_seed(args.seed)
    with torch.device("cuda"):
        model = Generator(cfg).eval()
        disc = Discriminator(cfg)
    states = (model.state_dict(), {k: v.clone() for k, v in disc.state_dict().items()})
    calls = []
    x0 = torch.randn(args.batch, cfg.hidden_dim, device="cuda")
    with recorded_bias_act_calls(bias_act_mod, calls), torch.no_grad():
        disc.bg_decoder(x0)
    del disc
    if len(calls) != 48:
        raise AssertionError(f"{len(calls)} bias_act calls in one bg_decoder forward, expected 48")
    bias_cases = bias_act_phase(torch, bias_act_mod, calls, args.seed)

    # 4. full-width model: kernel vs plain attention (fp32, bf16), bf16 vs
    # fp32, card vs CPU
    with torch.device("cuda"):
        plain = Generator(cfg, flash_attention=False).eval()
    plain.load_state_dict(states[0], strict=True)
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
    bf16.load_state_dict(states[0], strict=True)
    bf16_plain.load_state_dict(states[0], strict=True)
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
    cpu_model.load_state_dict({k: v.cpu() for k, v in states[0].items()}, strict=True)
    with torch.inference_mode():
        got = model(**to_device(torch, small, "cuda")).cpu()
        want = cpu_model(**to_device(torch, small, "cpu"))
    err_cpu = (got - want).abs().max().item()
    if not err_cpu <= CPU_TOL:
        raise AssertionError(f"Generator card vs CPU: max-abs {err_cpu}")
    log(f"Generator fp32 B=1 T=64, card vs CPU: bbox_fake max-abs {err_cpu:.3e}")
    del cpu_model, model, batch

    # 5. serving, slice 1's main path: counts from 0, read right after
    reqs = requests(np, cfg, args.batch, args.seed)
    variants = []
    for dtype_name in ("float32", "bfloat16"):
        for t in (256, 64):
            vcfg = dataclasses.replace(cfg, max_text_length=t, text_len_table=256)
            with torch.device("cuda"):
                m = Generator(vcfg, dtype=getattr(torch, dtype_name))
            m.load_state_dict(states[0], strict=True)
            variants.append((dtype_name, t, m.eval()))
    serving = []
    zero_counters(attention, bias_act_mod)
    forwards = 0
    for dtype_name, t, m in variants:
        e2e = []
        for i in range(4):  # the first batch warms up
            before = attention.LAUNCHES["fused_attention"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            layouts = generate_layouts(m, reqs, seed=args.seed + i, device="cuda")
            torch.cuda.synchronize()
            e2e.append(time.perf_counter() - t0)
            forwards += 1
            n = attention.LAUNCHES["fused_attention"] - before
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
    serve_launches = attention.LAUNCHES["fused_attention"]
    if serve_launches != forwards * cfg.bert_num_encoder_layers or counters(attention, bias_act_mod)[1:] != (0, 0):
        raise AssertionError(f"serving launched {counters(attention, bias_act_mod)} in {forwards} forwards")
    log(f"main path (serving): {forwards} served batches, fused_attention launched {serve_launches} times")

    # 6. the forward alone, outside the counted run: time and device profile
    forward_phase(torch, variants, serving, np, args, card)
    del variants
    torch.cuda.empty_cache()

    # 7. train step, slice 2's main path
    train = train_phase(torch, np, cfg, states, args, card, attention, bias_act_mod)

    # 8. step correctness
    correctness = step_correctness_phase(torch, np, cfg, states, args, attention, bias_act_mod)

    kernels = kernel_records(attn_cases, bias_cases, serve_launches, train)
    log(json.dumps({"serving": serving, "train": train, "step_correctness": correctness,
                    "model_max_abs": err, "model_bf16_max_abs": err_bf16,
                    "model_bf16_vs_fp32_max_abs": err_bf16_fp32, "cpu_max_abs": err_cpu,
                    "attention_cases": attn_cases, "bias_act_cases": bias_cases,
                    "build_s": build_s, "wall_s": time.perf_counter() - t_start}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


def kernel_records(attn_cases, bias_cases, serve_launches: int, train: list) -> list:
    """The kernels line: each kernel at its representative case (fp32,
    T=256 for attention; one fp32 step's 48 bias_act calls summed), with
    the launches of the main path that runs it."""
    def attn(rate):
        return next(c for c in attn_cases if c["dtype"] == "float32" and c["shape"][2] == 256
                    and c["dropout_rate"] == rate)

    train_launches = {k: sum(r["launches"][k] for r in train)
                      for k in ("fused_attention", "bias_act", "bias_act_backward")}
    src = "layoutdetr_tpu_torch/ops/csrc/"
    out = []
    for name, rate, launches in (("fused_attention", 0.0, serve_launches),
                                 ("fused_attention_dropout", DROPOUT,
                                  train_launches["fused_attention"])):
        c = attn(rate)
        out.append(dict(name=name, route="cuda", source=src + "attention.cu",
                        replaces="layoutdetr_tpu/ops/attention.py:98", launches=launches,
                        max_abs_err=c["max_abs_err"], ms=c["ms"], plain_ms=c["plain_ms"],
                        bound_ms=c["bound_ms"], bound_by=c["bound_by"], library_ms=c["library_ms"],
                        cases=[x for x in attn_cases if x["dropout_rate"] == rate]))
    tot = per_step_totals(bias_cases, "float32")
    tot16 = per_step_totals(bias_cases, "bfloat16")
    for name, key in (("bias_act", "fwd"), ("bias_act_backward", "bwd")):
        out.append(dict(name=name, route="cuda", source=src + "bias_act.cu",
                        replaces="layoutdetr_tpu/ops/bias_act.py:145", launches=train_launches[name],
                        max_abs_err=tot[f"max_rel_err_{key}"], ms=tot[f"{key}_ms"],
                        plain_ms=tot[f"plain_{key}_ms"], bound_ms=tot[f"{key}_bound_ms"],
                        bound_by="bytes", library_ms=tot[f"library_{key}_ms"],
                        library_calls=tot["library_calls"],
                        ms_on_library_calls=tot[f"{key}_ms_library_calls"],
                        per_step_bfloat16=dict(ms=tot16[f"{key}_ms"],
                                               plain_ms=tot16[f"plain_{key}_ms"],
                                               bound_ms=tot16[f"{key}_bound_ms"],
                                               library_ms=tot16[f"library_{key}_ms"],
                                               ms_on_library_calls=tot16[f"{key}_ms_library_calls"]),
                        note="ms, plain_ms and bound_ms sum one step's 48 calls; library_ms "
                             "sums only the library_calls calls that are linear with gain 1 and "
                             "no clamp (torch.add forward, torch.sum of dy for db backward), "
                             "beside the kernel's ms_on_library_calls on the same calls; the "
                             "lrelu calls have no library call (none); max_abs_err is relative "
                             "to max |y| (|dx|, |db|)"))
    return out


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
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  {e.key[:100]}")


if __name__ == "__main__":
    sys.exit(main())
