#!/usr/bin/env python3
"""Run the PyTorch port's main paths on one NVIDIA GPU and hold every
kernel on them against its plain version.

    python3 chip_smoke.py [--seed 0] [--batch 16]
    python3 chip_smoke.py --bias-act-only
    python3 chip_smoke.py --attention-only

The second form runs phases 1-3 for bias_act alone, adds where a call's
host time goes (two ways to read the current stream, the host us of a
call beside torch.add / torch.sum / empty_like), and prints one JSON line
and no ok line. The third does the same for fused_attention: its 8 cases,
and the host us of a call at [18, 4, 64, 192] bf16 beside sdpa's, split
into plan and checks, empty_like, the per-call tensor-map encoding, a bare
ctypes call and the stream read.

Phases (any failure ends the run with a non-zero exit and no result):

1. device: name and power limit (nvidia-smi);
2. build: the CUDA kernels from the sources in this checkout (nvcc,
   sm_90a), one nvcc per source, all started together, timed;
3. kernels: each kernel vs its plain PyTorch version at the main paths'
   shapes, with its time, the plain version's, one PyTorch library call's
   and the card's bound:
   - fused_attention [rows, 4, T, 192] at every shape of the main paths:
     serving and the train step (rows B*9, T in {256, 64}), the training
     run at its auto bucket T (16 on its zip, a partial 64-key chunk):
     rows B*9 (main and R1 steps, the metric ticks), (B/2)*9 (path
     length), 9 (module summaries, the served request) and 36 (image
     snapshot), and the evaluation (rows B*9 and the last partial batch's,
     at T=16 and T=256); fp32 and bf16, key padding down to length 2;
     deterministic, and with dropout 0.1 against the plain version with
     the same Philox keep mask; each case's share of its bound and its
     time over sdpa's;
   - bias_act forward and backward at every distinct shape of the train
     step's 48 calls (D's bg_decoder at batch 16), fp32 and bf16 (b in
     x's dtype, as the models pass it; a bf16 call also with b in fp32,
     which must give the same bits), db bit-equal in two runs, each
     call's us beside torch.add / torch.sum; the autograd round trip
     through ``bias_act`` against eager ``x + b`` at [16, 512] linear and
     the largest lrelu call; one kernel launch a backward call
     (profiled);
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
   (B=2, T=64) on the card vs on the CPU;
9. the training run (slice 3's main path): ``python -m
   layoutdetr_tpu_torch.train`` through ``train.main`` at full width
   (GeneratorConfig() widths, weights random from --seed) on a structured
   synthetic zip of 64 samples (256^2 backgrounds, up to 9 elements), bf16,
   --max-text-length auto, ADA, R1 (gamma 1) and path length (weight 2),
   the device feed, a snapshot each tick, the default ``--metrics
   layout_fid50k_val`` at each snapshot tick on a val.zip of 64 structured
   samples beside the run's zip, 17 steps: 17 main steps, 5
   path-length steps (batches 0, 4, 8, 12, 16) and 2 R1 steps (0, 16), with
   the launch counts set to 0 before and read after: 12 attention launches
   with dropout a main step; 12 deterministic ones a reg step, a G and a D
   forward of the startup module summaries, an image snapshot (one a
   tick) and each G_ema forward of the metric (4 a tick); 48 bias_act
   forward and 48 backward launches a main step, plus 48 forward in D's
   summary, none in a reg step. Checks: finite tick lines, stats.jsonl and
   metric lines (one a snapshot tick), every step's stats present, ADA's p
   updated 4 times,
   the snapshot and its .gcfg.json, the run's T the one phase 3 checked,
   trainable parameters moved and frozen ones not; then a resume from the
   snapshot through the host loader (--device-feed off --workers 2
   --max-steps 2), whose restored state must equal the snapshot bit for
   bit, one request served from the snapshot by ``generate --ckpt``
   (G_ema), and ADA's transform on the card at p = 1 on a device-fed batch
   against the CPU with the same draws and noise (CONDITIONAL_SAFE and the
   full pipe; the run's p stays near 0 with a random D). sec/kimg, the reg
   steps' share of the step time (the stream span between CUDA events
   around each step) and peak memory are printed beside the launch counts;
10. evaluation (slice 4's main path): ``python -m
   layoutdetr_tpu_torch.evaluate`` through ``evaluate.main``, with the
   launch counts set to 0 before and read after: (a) phase 9's last
   snapshot (T=16, its G_ema in fp32) on the val.zip, all four metrics,
   ``--max-items 64 --batch 16``, with ``--inception-ckpt`` a full
   InceptionV3 state dict from seeded random weights (pytorch-fid naming);
   (b) a full-width fp32 Generator (weights from --seed) written by
   ``save_generator`` at T=256, the reference workload, running
   ``layout_fid50k_val`` and the layout suite on 40 items (a partial last
   batch). Checks: every value finite, one jsonl line per metric,
   ``rendering_val``'s fake and real banners equal in number, and 12
   deterministic attention launches per G_ema forward (counted at
   ``generate_layouts``). Then LayoutNet and Inception features on the card
   against the CPU (fp32, same inputs). Printed: each metric's
   ``total_time``, layouts generated a second, Inception images a second,
   host compositing ms an image and peak memory.

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
import tempfile
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
# The keep mask's kept fraction: within 1e-3 of 1 - rate, or 5 binomial
# standard deviations where the mask has too few entries for that (at
# T=16 one sd is 7.8e-4 for 144 rows, 3.1e-3 for 9).
KEPT_TOL = 1e-3
WORDS = ("summer sale up to 50% off shop now free shipping new arrivals limited time only "
         "sign up today exclusive deals best price learn more the ultimate collection").split()
LABELS = ("header", "pre-header", "post-header", "body text", "disclaimer / footnote",
          "button", "callout", "logo")
# LayoutNet and Inception features, card vs CPU, fp32 without TF32, same
# weights and inputs: cuBLAS and cuDNN sum in other orders than the CPU's
# kernels. LayoutNet: 4 post-norm layers of 256-wide GEMMs, like the
# Generator's DETR stack (CPU_TOL). Inception: ~94 convolutions with
# fan-ins up to 3 x 3 x 448 and no normalisation between them but frozen
# BN; cuDNN may also pick Winograd or FFT algorithms, which round more.
LAYOUTNET_CPU_TOL = 1e-4  # of max |feature|
INCEPTION_CPU_TOL = 1e-3  # of max |feature|
EVAL_ITEMS, EVAL_WIDE_ITEMS = 64, 40  # phase 10 (a) and (b); 40 = 2 x 16 + a partial 8
SUITE = "overlap50k_alignment50k_layoutwise_iou50k_layoutwise_docsim50k_val"
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

def serving_attention_shapes(batch: int) -> list:
    """(rows, T) of the attention calls of serving and the train step:
    batch * 9 texts at T=256 and at the auto bucket 64."""
    return [(batch * 9, 256), (batch * 9, 64)]


def run_attention_shapes(batch: int, t: int) -> list:
    """(rows, T) of every attention call of the training run (phase 9) at
    its bucket T: the main and R1 steps and the metric ticks (batch * 9
    texts), the path-length step (batch // 2 samples), the module
    summaries and the request served from the snapshot (1 sample), and the
    image snapshot (4 samples)."""
    return [(batch * 9, t), (max(batch // 2, 1) * 9, t), (9, t), (4 * 9, t)]


def eval_attention_shapes(batch: int, run_t: int) -> list:
    """(rows, T) of the evaluation's attention calls (phase 10): G_ema at
    ``batch`` layouts and at the last partial batch's, (a) at the training
    run's T over EVAL_ITEMS items and (b) at T=256 over EVAL_WIDE_ITEMS."""
    out = []
    for items, t in ((EVAL_ITEMS, run_t), (EVAL_WIDE_ITEMS, 256)):
        out.append((batch * 9, t))
        if items % batch:
            out.append((items % batch * 9, t))
    return out


def attention_phase(torch, attention, seed: int, shapes: list) -> list:
    """Kernel vs plain at each (rows, T) of ``shapes``, [rows, 4, T, 192],
    fp32 and bf16, without and with dropout; one record per case."""
    import torch.nn.functional as F

    h, d = 4, 192
    scale = d ** -0.5
    cases = []
    for rate in (0.0, DROPOUT):
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            esize = torch.finfo(dtype).bits // 8
            for b, t in shapes:
                g = torch.Generator(device="cuda").manual_seed(seed + t + b)
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
                kept_tol = max(KEPT_TOL, 5.0 * math.sqrt(rate * (1.0 - rate) / mask.numel())) if rate else 0.0
                if rate and not abs(kept - (1.0 - rate)) <= kept_tol:
                    raise AssertionError(f"{dtype_name} {[b, h, t, d]}: kept fraction {kept}, expected "
                                         f"{1 - rate} +- {kept_tol}")

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
                           tol=tol, kept_fraction=kept, kept_tol=kept_tol, ms=ms, plain_ms=plain_ms,
                           library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                           share_of_bound=bound_ms / ms, vs_library=ms / library_ms,
                           gflop=flops / 1e9, mbytes=nbytes / 1e6, tflops=flops / ms / 1e9)
                log(f"fused_attention {dtype_name} {rec['shape']} dropout {rate}: max-abs {err:.3e} "
                    f"(bar {tol:.3e}), kept {kept:.5f}  kernel {ms:.4f} ms ({rec['tflops']:.2f} "
                    f"TFLOP/s)  plain {plain_ms:.4f} ms  sdpa {library_ms:.4f} ms  bound "
                    f"{bound_ms:.4f} ms ({bound_by})  share of bound {rec['share_of_bound']:.3f}, "
                    f"kernel / sdpa {rec['vs_library']:.3f}")
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
    with the number of times a step makes that call. b is in x's dtype, as
    the models pass it (``self.bias.to(x.dtype)``). db must be bit-equal
    in two runs, and a bf16 call must give the same bits with b widened
    to fp32 (the kernel then reads the same values)."""
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
            b = torch.randn(shape[dim], device="cuda", generator=g).to(dtype)
            dy = torch.randn(shape, device="cuda", generator=g).to(dtype)
            args = (dim, act, alpha, gain, clamp)
            y = bias_act_mod.bias_act_forward(x, b, *args)
            dx, db = bias_act_mod.bias_act_backward(dy, x, b, *args)
            _, db2 = bias_act_mod.bias_act_backward(dy, x, b, *args)
            torch.cuda.synchronize()
            if not torch.equal(db, db2):
                raise AssertionError(f"bias_act {dtype_name} {shape} {act}: db differs between runs")
            if dtype != torch.float32:
                y32 = bias_act_mod.bias_act_forward(x, b.float(), *args)
                dx32, db32 = bias_act_mod.bias_act_backward(dy, x, b.float(), *args)
                if not (torch.equal(y, y32) and torch.equal(dx, dx32) and torch.equal(db, db32)):
                    raise AssertionError(f"bias_act {dtype_name} {shape} {act}: a bf16 b and the "
                                         f"same b in fp32 differ")
                del y32, dx32, db32
            want_y = bias_act_mod.bias_act_ref(x.float(), b.float(), *args)
            want_dx, want_db = bias_act_mod.bias_act_ref_backward(dy.float(), x.float(), b.float(),
                                                                  *args)
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
            bview = b.view([-1 if i == dim else 1 for i in range(len(shape))])
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
            pass_through = act == "linear" and gain == 1.0 and clamp is None
            lib_fwd = lib_bwd = lib_err = None
            if pass_through:
                others = [i for i in range(len(shape)) if i != dim]
                lib_err = ((torch.add(x, bview).float() - want_y).abs().max().item()
                           / max(want_y.abs().max().item(), 1e-30))
                if dtype_name == "float32" and not lib_err <= tol_y:  # the same fp32 add
                    raise AssertionError(f"torch.add vs bias_act_ref {shape}: {lib_err}")
                lib_fwd = cuda_ms(torch, lambda: torch.add(x, bview), 20)
                lib_bwd = cuda_ms(torch, lambda: torch.sum(dy, dim=others, dtype=torch.float32), 20)
            # ~4 operations an element forward (add, act, gain, clamp), ~6
            # backward. Bytes: x read and y written forward; backward dy read,
            # x read where act' or the clamp need z, dx written unless it is
            # dy itself (linear, gain 1, no clamp); b read (x's dtype) and db
            # written (fp32).
            need_x = act != "linear" or clamp is not None
            bwd_bytes = n * es * (1 + need_x + (not pass_through)) + (es + 4) * shape[dim]
            fb, fby = bound(4.0 * n, 2.0 * n * es + es * shape[dim], "float32")
            bb, bby = bound(6.0 * n, bwd_bytes, "float32")
            rec = dict(dtype=dtype_name, shape=list(shape), act=act, gain=gain, clamp=clamp,
                       per_step=per_step, rel_err=errs, db_bit_equal=True, fwd_ms=fwd_ms,
                       bwd_ms=bwd_ms, plain_fwd_ms=plain_fwd, plain_bwd_ms=plain_bwd,
                       eager_two_call_ms=eager_ms, library_fwd_ms=lib_fwd, library_bwd_ms=lib_bwd,
                       library_rel_err=lib_err, fwd_bound_ms=fb, fwd_bound_by=fby,
                       bwd_bound_ms=bb, bwd_bound_by=bby)
            lib = ("none" if lib_fwd is None else
                   f"torch.add {lib_fwd * 1e3:.1f} us / torch.sum {lib_bwd * 1e3:.1f} us")
            log(f"bias_act {dtype_name} {list(shape)} {act} x{per_step}/step: rel err y "
                f"{errs['y']:.2e} dx {errs['dx']:.2e} db {errs['db']:.2e} (db bit-equal in 2 runs)  "
                f"fwd {fwd_ms * 1e3:.1f} us a call (plain {plain_fwd:.4f} ms, two-call "
                f"{eager_ms:.4f} ms, bound {fb * 1e3:.3f} us {fby})  bwd {bwd_ms * 1e3:.1f} us a call "
                f"(plain {plain_bwd:.4f} ms, bound {bb * 1e3:.3f} us {bby})  library {lib}")
            records.append(rec)
            del x, b, dy, y, dx, db, db2, want_y, want_dx, want_db
    return records


def round_trip_phase(torch, bias_act_mod, calls: list, seed: int) -> list:
    """A labelled extra: what the train step pays for one bias_act, the
    autograd round trip (``bias_act`` forward, then the gradients of x and
    b through ``_BiasAct``) against the same function in eager ops with
    autograd, and against ``x + b`` alone, at [16, 512] linear and at the
    largest lrelu call; b in x's dtype, as the models pass it."""
    import torch.nn.functional as F

    lrelu = max((c for c in calls if c[2] == "lrelu"), key=lambda c: math.prod(c[0]))
    fc = next(c for c in calls if c[0] == (16, 512) and c[2] == "linear")
    out = []
    for shape, dim, act, alpha, gain, clamp in (fc, lrelu):
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            g = torch.Generator(device="cuda").manual_seed(seed)
            x = torch.randn(shape, device="cuda", generator=g).to(dtype).requires_grad_(True)
            b = torch.randn(shape[dim], device="cuda", generator=g).to(dtype).requires_grad_(True)
            dy = torch.randn(shape, device="cuda", generator=g).to(dtype)
            view = [-1 if i == dim else 1 for i in range(len(shape))]

            def kernel():
                y = bias_act_mod.bias_act(x, b, dim=dim, act=act, alpha=alpha, gain=gain,
                                          clamp=clamp)
                torch.autograd.grad(y, (x, b), dy)

            def eager():
                z = x + b.view(view)
                y = F.leaky_relu(z, alpha) * gain if act == "lrelu" else z * gain
                if clamp is not None:
                    y = y.clamp(-clamp, clamp)
                torch.autograd.grad(y, (x, b), dy)

            def add_only():
                torch.autograd.grad(x + b.view(view), (x, b), dy)

            rec = dict(dtype=dtype_name, shape=list(shape), act=act,
                       kernel_ms=cuda_ms(torch, kernel, 20), eager_ms=cuda_ms(torch, eager, 20),
                       eager_add_ms=cuda_ms(torch, add_only, 20))
            log(f"bias_act round trip (autograd) {dtype_name} {list(shape)} {act}: kernels "
                f"{rec['kernel_ms'] * 1e3:.1f} us, eager same function {rec['eager_ms'] * 1e3:.1f} us, "
                f"eager x + b {rec['eager_add_ms'] * 1e3:.1f} us")
            out.append(rec)
            del x, b, dy
    return out


def kernels_per_backward(torch, bias_act_mod, calls: list) -> dict:
    """The kernels that one backward call at each distinct call of a step
    launches, all of them inside one profiled region: as many kernels as
    calls, each a bias_act backward kernel. Phase 3 has checked each
    call's db, so no call launched none, and each launched one. The
    profiler may drop kernel records (a region of 20 single-call
    regions once saw 4 calls with none), so a region that shows fewer
    kernels than calls is profiled again, up to 3 times; one that shows
    more fails."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    distinct = list(dict.fromkeys(calls))
    inputs = []
    for shape, dim, *_ in distinct:
        x = torch.randn(shape, device="cuda")
        inputs.append((x, torch.randn(shape[dim], device="cuda")))
    # each call's plan built and its kernel loaded outside the region
    for (x, b), (_, dim, act, alpha, gain, clamp) in zip(inputs, distinct):
        bias_act_mod.bias_act_backward(x, x, b, dim, act, alpha, gain, clamp)
    torch.cuda.synchronize()
    for attempt in range(1, 4):
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for (x, b), (_, dim, act, alpha, gain, clamp) in zip(inputs, distinct):
                bias_act_mod.bias_act_backward(x, x, b, dim, act, alpha, gain, clamp)
            torch.cuda.synchronize()
        kernels = {e.key[:80]: e.count for e in prof.key_averages() if e.device_type.name == "CUDA"}
        if sum(kernels.values()) >= len(distinct):
            break
    out = dict(calls=len(distinct), kernels=sum(kernels.values()), by_name=kernels,
               profiled_regions=attempt)
    log(f"bias_act backward, one call at each of the {len(distinct)} distinct calls in one "
        f"profiled region: {out['kernels']} kernels ({kernels}), region {attempt} of 3")
    if out["kernels"] != len(distinct) or any("bwd_" not in k for k in kernels):
        raise AssertionError(f"a bias_act backward must be one launch: {out}")
    del inputs
    return out


def host_costs(torch, bias_act_mod) -> dict:
    """Host us a call of the two ways to read the current stream, and
    where a bias_act call's host time goes at [16, 512] fp32 linear."""
    reps = 20000
    t0 = time.perf_counter()
    for _ in range(reps):
        torch.cuda.current_stream(0).cuda_stream
    obj_us = (time.perf_counter() - t0) / reps * 1e6
    t0 = time.perf_counter()
    for _ in range(reps):
        torch._C._cuda_getCurrentRawStream(0)
    raw_us = (time.perf_counter() - t0) / reps * 1e6
    log(f"current stream, host us a call: torch.cuda.current_stream(0).cuda_stream {obj_us:.3f}, "
        f"torch._C._cuda_getCurrentRawStream(0) {raw_us:.3f}")

    # host us a call (perf_counter over back-to-back calls, the card keeping up)
    def host_us(fn, reps=2000):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / reps * 1e6

    x = torch.randn(16, 512, device="cuda")
    b = torch.randn(512, device="cuda")
    args = (1, "linear", 0.0, 1.0, None)
    fwd = bias_act_mod._lib()[0]
    parts = dict(forward_call=host_us(lambda: bias_act_mod.bias_act_forward(x, b, *args)),
                 backward_call=host_us(lambda: bias_act_mod.bias_act_backward(x, x, b, *args)),
                 torch_add=host_us(lambda: torch.add(x, b.view(1, -1))),
                 torch_sum=host_us(lambda: torch.sum(x, dim=0, dtype=torch.float32)),
                 empty_like=host_us(lambda: torch.empty_like(x)),
                 plan_and_checks=host_us(lambda: bias_act_mod._check(x, b, *args)),
                 ctypes_call_no_launch=host_us(lambda: fwd(0, 0, 0, 0, 0, 0)))
    log("host us a call, [16, 512] fp32 linear: "
        + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()))
    return dict(stream_object_us=obj_us, raw_stream_us=raw_us, host_us_16x512=parts)


def attention_host_costs(torch, attention) -> dict:
    """Host us a call of fused_attention at [18, 4, 64, 192] bf16 (the
    strided view BERT hands over), 2000 back-to-back calls, beside one
    sdpa call on the same inputs, and where the call's time goes: plan and
    checks, empty_like, the four tensor maps encoded per call, a bare
    ctypes call and the raw stream read."""
    import torch.nn.functional as F

    q, k, v = (torch.randn(18, 64, 4, 192, device="cuda").bfloat16().transpose(1, 2)
               for _ in range(3))
    bias = torch.zeros(18, 64, device="cuda")
    amask = bias.bfloat16()[:, None, None, :]
    fn, enc, stream = attention._lib()
    plan = attention._check(q, k, v, bias, None, 0.125, 0.0)
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())

    def host_us(call, reps=2000):
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / reps * 1e6

    reps = 2000
    t0 = time.perf_counter()
    if enc(plan.addr, *ptrs, reps) != 0:
        raise AssertionError("encoding the tensor maps failed")
    encode_us = (time.perf_counter() - t0) / reps * 1e6
    parts = dict(
        fused_attention_call=host_us(lambda: attention.fused_attention(q, k, v, bias, scale=0.125)),
        sdpa_call=host_us(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=amask,
                                                                 scale=0.125)),
        plan_and_checks=host_us(lambda: attention._check(q, k, v, bias, out, 0.125, 0.0)),
        empty_like=host_us(lambda: torch.empty_like(q)),
        encode_four_maps=encode_us,
        ctypes_call_no_launch=host_us(lambda: fn(0, 0, 0, 0, 0, 0, 0, 0, 0)),
        raw_stream=host_us(lambda: stream(0)))
    log("attention host us a call, [18, 4, 64, 192] bf16: "
        + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()))
    return parts


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


def counters(attention, bias_act_mod) -> dict:
    """Every kernel's launch count, by its name in the kernels line."""
    return dict(fused_attention=attention.LAUNCHES["fused_attention"],
                fused_attention_dropout=attention.LAUNCHES["fused_attention_dropout"],
                bias_act=bias_act_mod.LAUNCHES["forward"],
                bias_act_backward=bias_act_mod.LAUNCHES["backward"])


def zero_counters(attention, bias_act_mod):
    attention.LAUNCHES.update(fused_attention=0, fused_attention_dropout=0)
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
        launches = counters(attention, bias_act_mod)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        steps = 5
        # the hoisted text pass drops out: 12 dropout-form launches a step
        want = dict(fused_attention=0, fused_attention_dropout=12 * steps, bias_act=48 * steps,
                    bias_act_backward=48 * steps)
        if launches != want:
            raise AssertionError(f"train {dtype_name} T={t}: launches {launches} in {steps} steps, "
                                 f"expected {want}")
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
                   launches_per_step={k: v // steps for k, v in launches.items()}, launches=launches,
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
# 9. the training run
# ---------------------------------------------------------------------------

RUN_STEPS, RESUME_STEPS, G_REG, D_REG, ADA_INTERVAL = 17, 2, 4, 16, 4
RUN_SAMPLES = 64  # the training zip's and the val.zip's


def same_bits(torch, a, b, where: str = "") -> None:
    """Raise unless ``a`` and ``b`` (nested dicts/lists of tensors and
    scalars) are equal bit for bit, dtype included."""
    if isinstance(a, torch.Tensor):
        if not (isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.cpu(), b.cpu())):
            raise AssertionError(f"{where}: differs")
    elif isinstance(a, dict):
        if a.keys() != b.keys():
            raise AssertionError(f"{where}: keys differ")
        for k in a:
            same_bits(torch, a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"{where}: lengths differ")
        for i, (x, y) in enumerate(zip(a, b)):
            same_bits(torch, x, y, f"{where}[{i}]")
    elif a != b:
        raise AssertionError(f"{where}: {a} != {b}")


@contextlib.contextmanager
def checked_restore(torch, train_loop, seen: list):
    """Inside, the training loop's restore is followed by a bit-for-bit
    comparison of the restored state with the snapshot file."""
    from layoutdetr_tpu_torch.utils.checkpoint import load_snapshot, snapshot_of

    real = train_loop.restore_checkpoint

    def restore(path, state):
        out = real(path, state)
        same_bits(torch, snapshot_of(state), load_snapshot(path), "restored state")
        seen.append(state.step)
        return out

    train_loop.restore_checkpoint = restore
    try:
        yield
    finally:
        train_loop.restore_checkpoint = real


def read_run(run_dir: str) -> tuple:
    """(stats.jsonl records, the tick status lines of log.txt)."""
    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        records = [json.loads(line) for line in f]
    with open(os.path.join(run_dir, "log.txt")) as f:
        ticks = [line.split() for line in f if line.startswith("tick ")]
    return records, ticks


def check_ticks(records: list, ticks: list, steps: int, what: str) -> None:
    """Every tick line's numbers and every reported stat finite; each main
    stat reported once a step (the collector drops non-finite values)."""
    if len(records) != len(ticks) or not records:
        raise AssertionError(f"{what}: {len(records)} stats.jsonl lines, {len(ticks)} tick lines")
    for fields in ticks:
        values = [float(v) for v in fields[1::2]]
        if not all(math.isfinite(v) for v in values):
            raise AssertionError(f"{what}: tick line {' '.join(fields)}")
    for rec in records:
        bad = [k for k, v in rec.items() if isinstance(v, dict) and v["num"]
               and not (math.isfinite(v["mean"]) and math.isfinite(v["std"]))]
        bad += [k for k, v in rec.items() if isinstance(v, float) and not math.isfinite(v)]
        if bad:
            raise AssertionError(f"{what}: non-finite {bad}")
    got = sum(r["Loss/G/loss_Ggen"]["num"] for r in records)
    if got != steps or sum(r["Loss/D/loss_Dreal"]["num"] for r in records) != steps:
        raise AssertionError(f"{what}: main-step stats of {got} steps, expected {steps}")


def run_dataset(tmp: str, seed: int) -> tuple:
    """The training run's dataset, a structured synthetic zip of RUN_SAMPLES
    samples (256^2 backgrounds, up to 9 elements), the val.zip beside it
    (as many, another seed) and the text length T that ``--max-text-length auto``
    picks for the training zip."""
    from layoutdetr_tpu_torch.data.dataset import LayoutDataset
    from layoutdetr_tpu_torch.data.synthetic import make_synthetic_zip
    from layoutdetr_tpu_torch.train import auto_text_length

    zip_path, val_path = (make_synthetic_zip(os.path.join(tmp, name), num_samples=RUN_SAMPLES,
                                             image_size=256, max_elements=9, seed=s, structured=True)
                          for name, s in (("train.zip", seed), ("val.zip", seed + 1)))
    measured = LayoutDataset(zip_path, cache=False).measured_max_text_tokens()
    return zip_path, val_path, auto_text_length(measured)


def augment_on_card(torch, np, zip_path: str, t: int, args, card) -> list:
    """ADA's transform on the card at p = 1 (every group fires in every
    sample) on a batch of backgrounds gathered by the device feed, for
    CONDITIONAL_SAFE and AugmentConfig(): the host draws copied up, the
    affine resample, the color matrices, the reflect pad and grouped conv
    of the band filter, the noise image drawn by a device generator from
    the draws' seed, and cutout. Held against the same call on the CPU with
    the same draws and that noise image, to 1e-5 (CONDITIONAL_SAFE) and
    2e-5 (the full pipe) of max |out|, the CPU tests' bars against JAX."""
    from layoutdetr_tpu_torch.data.dataset import LayoutDataset
    from layoutdetr_tpu_torch.data.device_cache import DeviceDatasetCache, gather_batch
    from layoutdetr_tpu_torch.training.augment import (
        CONDITIONAL_SAFE,
        AugmentConfig,
        apply_augment,
        draw_augment_params,
    )

    cache = DeviceDatasetCache(LayoutDataset(zip_path, max_text_length=t, cache=False), "cuda")
    idx = np.random.default_rng(args.seed).permutation(RUN_SAMPLES)[:args.batch]
    bg = gather_batch(cache.arrays, cache.put_indices(idx))["background"]
    bg_cpu = bg.cpu()
    out = []
    for name, cfg, tol in (("CONDITIONAL_SAFE", CONDITIONAL_SAFE, 1e-5),
                           ("AugmentConfig()", AugmentConfig(), 2e-5)):
        params = draw_augment_params(args.batch, 1.0, torch.Generator().manual_seed(args.seed), cfg)
        got = apply_augment(bg, params, cfg)
        gen = torch.Generator(device="cuda").manual_seed(params["noise_seed"])
        noise = torch.randn(bg.shape, generator=gen, device="cuda")
        want = apply_augment(bg_cpu, params, cfg, noise=noise.cpu())
        got = got.cpu()
        scale = want.abs().max().item()
        rel = (got - want).abs().max().item() / scale
        changed = (got - bg_cpu).abs().amax(dim=(1, 2, 3))
        if (got.shape != bg_cpu.shape or not torch.isfinite(got).all() or not rel <= tol
                or not bool((changed > 0).all())):
            raise AssertionError(f"augment {name} card vs CPU: {tuple(got.shape)}, relative max-abs "
                                 f"{rel} (bar {tol}), per-sample change {changed.tolist()}")
        ms = cuda_ms(torch, lambda: apply_augment(bg, params, cfg), 5)
        rec = dict(cfg=name, shape=list(bg.shape), p=1.0, rel_max_abs=rel, tol=tol, max_abs_out=scale,
                   ms=ms)
        log(f"augment {name} p=1 on {list(bg.shape)}, card vs CPU (same draws, same noise): relative "
            f"max-abs {rel:.3e} (bar {tol:.0e}); {ms:.3f} ms a call on the card  [{card}]")
        out.append(rec)
        del got, want, noise
    del cache, bg
    return out


@contextlib.contextmanager
def counted_generation(layout_fid, seen: dict):
    """Inside, every ``generate_layouts`` batch (one G_ema forward) is
    counted in ``seen``: ``forwards``, ``layouts`` and ``s``, the host
    seconds spent producing the batches (collate, copies, the forward and
    its copy back, which waits for the card)."""
    real = layout_fid.generate_layouts

    def counted(opts, indices, batch=16):
        it = real(opts, indices, batch)
        while True:
            t0 = time.perf_counter()
            try:
                bbox_fake, b = next(it)
            except StopIteration:
                return
            seen["s"] = seen.get("s", 0.0) + time.perf_counter() - t0
            seen["forwards"] = seen.get("forwards", 0) + 1
            seen["layouts"] = seen.get("layouts", 0) + bbox_fake.shape[0]
            yield bbox_fake, b

    layout_fid.generate_layouts = counted
    try:
        yield seen
    finally:
        layout_fid.generate_layouts = real


def read_jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def training_run_phase(torch, np, args, card, attention, bias_act_mod, tmp: str, zip_path: str,
                       t: int) -> dict:
    """Slice 3's main path, ``python -m layoutdetr_tpu_torch.train`` at full
    width on ``zip_path`` in ``tmp`` (whose auto text length is ``t``, the T
    phase 3 checked the run's attention shapes at; the val.zip beside it
    feeds the metric at each snapshot tick), then a resume through the host
    loader, one request served from the snapshot, and ADA's transform on
    the card against the CPU. The record's ``snapshot`` is the run's last."""
    import zipfile

    from layoutdetr_tpu_torch import generate
    from layoutdetr_tpu_torch import train as train_cli
    from layoutdetr_tpu_torch.config import GeneratorConfig
    from layoutdetr_tpu_torch.metrics import layout_fid
    from layoutdetr_tpu_torch.training import train_loop

    common = ["--data", zip_path, "--batch", str(args.batch), "--bf16", "--max-text-length",
              "auto", "--aug", "ada", "--gamma", "1", "--pl-weight", "2",
              "--seed", str(args.seed), "--snap", "1"]
    out = os.path.join(tmp, "runs")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters(attention, bias_act_mod)
    t0 = time.perf_counter()
    with counted_generation(layout_fid, {}) as gen:
        state = train_cli.main(["--outdir", out, *common, "--device-feed", "on",
                                "--max-steps", str(RUN_STEPS)])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = counters(attention, bias_act_mod)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    (run_name,) = os.listdir(out)
    run_dir = os.path.join(out, run_name)
    records, ticks = read_run(run_dir)

    # the launches: 12 attention with dropout a main step; 12
    # deterministic a reg step, a summary forward (G, D), an image
    # snapshot (one a tick) and a G_ema forward of the metric (64 val
    # items at batch 16 a tick); 48 + 48 bias_act a main step, 48 forward
    # in D's summary, none in a reg step
    g_regs = len(range(0, RUN_STEPS, G_REG))
    d_regs = len(range(0, RUN_STEPS, D_REG))
    metric_forwards = len(ticks) * math.ceil(RUN_SAMPLES / min(16, args.batch))
    if gen.get("forwards") != metric_forwards:
        raise AssertionError(f"training run: {gen.get('forwards')} metric forwards, expected "
                             f"{metric_forwards}")
    want = dict(fused_attention=12 * (g_regs + d_regs) + 12 * 2 + 12 * len(ticks)
                + 12 * metric_forwards,
                fused_attention_dropout=12 * RUN_STEPS, bias_act=48 * RUN_STEPS + 48,
                bias_act_backward=48 * RUN_STEPS)
    if launches != want:
        raise AssertionError(f"training run: launches {launches}, expected {want}")
    check_ticks(records, ticks, RUN_STEPS, "training run")
    metric_lines = read_jsonl(os.path.join(run_dir, "metric-layout_fid50k_val.jsonl"))
    fids = [r["results"]["layout_fid50k_val"] for r in metric_lines]
    if len(fids) != len(ticks) or not all(math.isfinite(v) for v in fids):
        raise AssertionError(f"training run: metric lines {fids} for {len(ticks)} ticks")
    if (sum(r.get("Loss/G/reg", {}).get("num", 0) for r in records) != g_regs
            or sum(r.get("Loss/D/reg", {}).get("num", 0) for r in records) != d_regs):
        raise AssertionError("training run: reg-step stats do not match the schedule")
    ada_updates = records[-1]["ada_updates"]
    if ada_updates != len(range(ADA_INTERVAL, RUN_STEPS, ADA_INTERVAL)):
        raise AssertionError(f"ADA's p was updated {ada_updates} times")
    snap = os.path.join(run_dir, f"network-snapshot-{RUN_STEPS * args.batch // 1000:06d}.pt")
    if not (os.path.exists(snap) and os.path.exists(snap + ".gcfg.json")):
        raise AssertionError(f"no snapshot {snap} with its .gcfg.json in {os.listdir(run_dir)}")
    if state.step != RUN_STEPS:
        raise AssertionError(f"state.step {state.step}")
    with open(snap + ".gcfg.json") as f:
        gcfg = GeneratorConfig.from_dict(json.load(f))
    if gcfg.max_text_length != t:
        raise AssertionError(f"the run trained at T={gcfg.max_text_length}; phase 3 checked T={t}")

    # trainable parameters moved, frozen ones did not: against the same
    # seeded init (G's frozen encoder copied into D, as the loop does)
    G0, D0 = train_loop.init_models(gcfg, "cuda", torch.bfloat16, args.seed)
    D0.text_encoder.load_state_dict(G0.text_encoder.state_dict())
    frozen, moved, unmoved = 0, 0, []
    for tag, mod, mod0 in (("G", state.G, G0), ("D", state.D, D0)):
        init = dict(mod0.named_parameters())
        for name, p in mod.named_parameters():
            same = torch.equal(p.detach(), init[name].detach())
            if not p.requires_grad:
                frozen += 1
                if not same:
                    raise AssertionError(f"frozen {tag}.{name} moved")
            elif not same:
                moved += 1
            elif ".crossattention." not in name and not name.endswith(".key.bias"):
                unmoved.append(f"{tag}.{name}")
    if unmoved or not frozen:
        raise AssertionError(f"trainable parameters that did not move: {unmoved[:8]}")
    del G0, D0
    run_main_s = sum(r["main_step_s"] for r in records)
    run_reg_s = sum(r["reg_step_s"] for r in records)
    last = records[-1]  # tick 1: steps 1-16, after the first step's warm-up
    rec = dict(steps=RUN_STEPS, g_reg_steps=g_regs, d_reg_steps=d_regs, ticks=len(ticks),
               wall_s=wall_s, sec_per_kimg=last["sec_per_kimg"],
               sec_per_kimg_ticks=[r["sec_per_kimg"] for r in records],
               main_step_s=run_main_s, reg_step_s=run_reg_s,
               reg_share=run_reg_s / (run_main_s + run_reg_s),
               reg_share_last_tick=last["reg_step_s"] / (last["main_step_s"] + last["reg_step_s"]),
               peak_memory_gb=peak_gb, devmem_peak_gb=max(r["devmem_peak_gb"] for r in records),
               launches=launches, launches_expected=want,
               ada_updates=ada_updates, augment_p=last["augment_p"],
               trainable_moved=moved, frozen_unchanged=frozen, T=gcfg.max_text_length,
               metric_layout_fid=fids, metric_total_time_s=[r["total_time"] for r in metric_lines],
               metric_forwards=metric_forwards, snapshot=snap)
    del state
    torch.cuda.empty_cache()
    log(f"training run bf16 batch {args.batch} T={gcfg.max_text_length} (auto), {RUN_STEPS} "
        f"steps + {g_regs} path-length + {d_regs} R1 steps: {rec['sec_per_kimg']:.2f} sec/kimg "
        f"(tick 1, steps 1-16), reg steps {100 * rec['reg_share']:.1f}% of the steps' step "
        f"time ({100 * rec['reg_share_last_tick']:.1f}% in tick 1; step time = the stream span "
        f"between CUDA events around each step, on these host-bound steps mostly the card "
        f"waiting on the host), peak memory {peak_gb:.2f} GiB, wall {wall_s:.1f} s  [{card}]")
    log(f"  launches: {launches} (as expected); ADA p updated {ada_updates} times "
        f"(p = {rec['augment_p']:.5f}); {moved} trainable tensors moved, {frozen} frozen "
        f"unchanged")
    log(f"  metric layout_fid50k_val at {len(ticks)} snapshot ticks ({RUN_SAMPLES} val items, "
        f"{metric_forwards} G_ema forwards, in the ticks' maintenance): "
        f"{', '.join(f'{v:.4f}' for v in fids)}; total_time "
        f"{', '.join(f'{r:.2f}' for r in rec['metric_total_time_s'])} s  [{card}]")

    # resume through the host loader, the restored state checked bit for bit
    restored: list = []
    out2 = os.path.join(tmp, "resumed")
    with checked_restore(torch, train_loop, restored):
        state = train_cli.main(["--outdir", out2, *common, "--metrics", "none", "--device-feed",
                                "off", "--workers", "2", "--max-steps", str(RESUME_STEPS),
                                "--resume", snap])
    records2, ticks2 = read_run(os.path.join(out2, os.listdir(out2)[0]))
    check_ticks(records2, ticks2, RESUME_STEPS, "resumed run")
    if restored != [RUN_STEPS] or state.step != RUN_STEPS + RESUME_STEPS:
        raise AssertionError(f"resume: restored at step {restored}, ended at {state.step}")
    rec["resume"] = dict(restored_step=restored[0], bit_exact=True, steps=RESUME_STEPS,
                         sec_per_kimg=records2[-1]["sec_per_kimg"])
    log(f"resume from {os.path.basename(snap)} (host loader, 2 workers): restored state equal to "
        f"the snapshot bit for bit at step {restored[0]}, then {RESUME_STEPS} steps")
    del state
    torch.cuda.empty_cache()

    # one request served from the snapshot (its G_ema)
    bg = os.path.join(tmp, "bg.png")
    with zipfile.ZipFile(zip_path) as zf, open(bg, "wb") as f:
        f.write(zf.read("00000000_background_orig.png"))
    zero_counters(attention, bias_act_mod)
    (layout,) = generate.main(["--ckpt", snap, "--bg", bg, "--strings", "summer sale|shop now",
                               "--string-labels", "header|button", "--device", "cuda",
                               "--outfile", os.path.join(tmp, "served", "banner")])
    served = attention.LAUNCHES["fused_attention"]
    if (counters(attention, bias_act_mod) != dict(fused_attention=12, fused_attention_dropout=0,
                                                  bias_act=0, bias_act_backward=0)
            or not np.isfinite(layout.bbox).all()
            or not ((layout.raw > 0) & (layout.raw < 1)).all()):
        raise AssertionError(f"serving from the snapshot: {served} launches, {layout.raw}")
    rec["served"] = dict(bbox=layout.bbox[layout.mask].tolist(), launches=served)
    log(f"served from the snapshot (generate --ckpt, G_ema): boxes "
        f"{np.round(layout.bbox[layout.mask], 4).tolist()}, {served} attention launches")
    rec["augment_on_card"] = augment_on_card(torch, np, zip_path, t, args, card)
    return rec


# ---------------------------------------------------------------------------
# 10. evaluation
# ---------------------------------------------------------------------------

def random_inception_state_dict(torch, seed: int) -> dict:
    """A full FID InceptionV3 state dict in pytorch-fid naming from seeded
    random weights: He-normal convolutions (activations keep their scale
    through the depth), frozen-BN statistics around identity."""
    from layoutdetr_tpu_torch.models.inception import InceptionV3

    with torch.random.fork_rng(devices=[]):
        shapes = {k: v.shape for k, v in InceptionV3().state_dict().items()}
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, shape in shapes.items():
        n = torch.randn(shape, generator=g)
        if k.endswith("conv.weight"):
            out[k] = n * math.sqrt(2.0 / math.prod(shape[1:]))
        elif k.endswith("bn.weight"):
            out[k] = 1.0 + 0.1 * n
        elif k.endswith("running_var"):
            out[k] = (1.0 + 0.1 * n).abs() + 0.5
        else:
            out[k] = 0.1 * n
    return out


@contextlib.contextmanager
def timed_image_fid(image_fid, compositing, seen: dict):
    """Inside, the image FID's feature calls (upload, resize, InceptionV3,
    features back: synchronised) and its compositing calls are timed in
    ``seen``: ``inception_s``/``inception_images``,
    ``compositing_s``/``composited``."""
    real_feature_fn, real_composite = image_fid._feature_fn, compositing.composite_batch
    seen.update(inception_s=0.0, inception_images=0, compositing_s=0.0, composited=0)

    def feature_fn(opts):
        fn = real_feature_fn(opts)

        def timed(imgs):
            t0 = time.perf_counter()
            out = fn(imgs)
            seen["inception_s"] += time.perf_counter() - t0
            seen["inception_images"] += len(imgs)
            return out

        return timed

    def composite(*a, **kw):
        t0 = time.perf_counter()
        out = real_composite(*a, **kw)
        seen["compositing_s"] += time.perf_counter() - t0
        seen["composited"] += len(out)
        return out

    image_fid._feature_fn, compositing.composite_batch = feature_fn, composite
    try:
        yield seen
    finally:
        image_fid._feature_fn, compositing.composite_batch = real_feature_fn, real_composite


def features_card_vs_cpu(torch, np, args, val_path: str, t: int, inc_path: str) -> dict:
    """LayoutNet (seeded, 8 labels) features of a batch of val layouts and
    InceptionV3 (the phase's random weights) features of 4 real-patch
    composites at 1024^2, on the card and on the CPU, fp32."""
    from layoutdetr_tpu_torch.data.dataset import LayoutDataset
    from layoutdetr_tpu_torch.metrics.compositing import composite_batch
    from layoutdetr_tpu_torch.models.inception import load_inception_params, make_feature_fn
    from layoutdetr_tpu_torch.models.layoutnet import LayoutNet

    b = LayoutDataset(val_path, max_text_length=t, load_patches=True,
                      load_background_orig=True).collate(list(range(args.batch)))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        net = LayoutNet(8).eval()
    inputs = [torch.from_numpy(b[k]) for k in ("bboxes", "labels", "padding_mask")]
    with torch.inference_mode():
        want = net.extract_features(*inputs)
        got = net.to("cuda").extract_features(*(x.cuda() for x in inputs)).cpu()
    ln_err = (got - want).abs().max().item() / want.abs().max().item()
    imgs = composite_batch(b["bboxes"][:4], b["bboxes"][:4], b["patches_orig"][:4], b["mask"][:4],
                           b["background_orig"][:4], b["W_page"][:4], b["H_page"][:4], 1024)
    want = make_feature_fn(load_inception_params(inc_path, "cpu"))(imgs)
    got = make_feature_fn(load_inception_params(inc_path, "cuda"))(imgs)
    inc_err = float(np.abs(got - want).max() / np.abs(want).max())
    out = dict(layoutnet_rel_max_abs=ln_err, layoutnet_tol=LAYOUTNET_CPU_TOL,
               inception_rel_max_abs=inc_err, inception_tol=INCEPTION_CPU_TOL,
               inception_max_abs_feature=float(np.abs(want).max()))
    log(f"card vs CPU, fp32: LayoutNet features of {args.batch} val layouts max-abs {ln_err:.3e} of max |f| "
        f"(bar {LAYOUTNET_CPU_TOL:.0e}); InceptionV3 features of 4 composites (1024^2 -> 299^2) "
        f"{inc_err:.3e} of max |f| = {out['inception_max_abs_feature']:.4f} (bar "
        f"{INCEPTION_CPU_TOL:.0e})")
    if not (ln_err <= LAYOUTNET_CPU_TOL and inc_err <= INCEPTION_CPU_TOL):
        raise AssertionError(f"features card vs CPU: {out}")
    return out


def evaluation_phase(torch, np, args, card, attention, bias_act_mod, tmp: str, snap: str,
                     val_path: str, t: int) -> dict:
    """Slice 4's main path, ``python -m layoutdetr_tpu_torch.evaluate``
    through ``evaluate.main`` on the val.zip: (a) the training run's last
    snapshot (T=``t``), all four metrics, with a random full InceptionV3;
    (b) a full-width fp32 Generator at T=256 from --seed, the layout FID
    and the layout suite. Counts from 0 before, read after."""
    from layoutdetr_tpu_torch import evaluate
    from layoutdetr_tpu_torch.config import GeneratorConfig
    from layoutdetr_tpu_torch.generate import save_generator
    from layoutdetr_tpu_torch.metrics import compositing, image_fid, layout_fid, metric_main
    from layoutdetr_tpu_torch.models.generator import Generator

    inc_path = os.path.join(tmp, "pt_inception.pth")
    torch.save(random_inception_state_dict(torch, args.seed), inc_path)
    torch.manual_seed(args.seed)
    with torch.device("cuda"):
        wide = Generator(GeneratorConfig())
    wide_path = os.path.join(tmp, "g_t256.pt")
    save_generator(wide, wide_path)
    del wide
    torch.cuda.empty_cache()

    runs = (("a", snap, metric_main.list_valid_metrics(), EVAL_ITEMS, ["--inception-ckpt", inc_path]),
            ("b", wide_path, ["layout_fid50k_val", SUITE], EVAL_WIDE_ITEMS, []))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters(attention, bias_act_mod)
    out, timing, forwards = {}, {}, 0
    t0 = time.perf_counter()
    with timed_image_fid(image_fid, compositing, timing), contextlib.chdir(tmp):
        for tag, ckpt, metrics, items, extra in runs:
            run_dir = os.path.join(tmp, f"eval_{tag}")
            os.makedirs(run_dir)
            with counted_generation(layout_fid, {}) as gen:
                results = evaluate.main(["--ckpt", ckpt, "--data", val_path, "--metrics",
                                         ",".join(metrics), "--batch", str(args.batch),
                                         "--max-items", str(items), "--run-dir", run_dir,
                                         "--seed", str(args.seed), "--device", "cuda", *extra])
            want_forwards = len(metrics) * math.ceil(items / args.batch)
            if gen.get("forwards") != want_forwards:
                raise AssertionError(f"evaluation ({tag}): {gen.get('forwards')} G_ema forwards, "
                                     f"expected {want_forwards}")
            forwards += want_forwards
            values = {f"{r['metric']}/{k}": v for r in results for k, v in r["results"].items()
                      if not isinstance(v, str)}
            lines = {m: read_jsonl(os.path.join(run_dir, f"metric-{m}.jsonl")) for m in metrics}
            if ([r["metric"] for r in results] != metrics or not all(map(math.isfinite, values.values()))
                    or any(len(v) != 1 for v in lines.values())):
                raise AssertionError(f"evaluation ({tag}): {values}, jsonl lines "
                                     f"{ {m: len(v) for m, v in lines.items()} }")
            out[tag] = dict(ckpt=os.path.basename(ckpt), items=items, values=values,
                            total_time_s={r["metric"]: r["total_time"] for r in results},
                            forwards=want_forwards, layouts=gen["layouts"], generation_s=gen["s"],
                            layouts_per_s=gen["layouts"] / gen["s"])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = counters(attention, bias_act_mod)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    want = dict(fused_attention=12 * forwards, fused_attention_dropout=0, bias_act=0,
                bias_act_backward=0)
    if launches != want:
        raise AssertionError(f"evaluation: launches {launches} in {forwards} G_ema forwards, "
                             f"expected {want}")
    rendered = out["a"]["values"]["rendering_val/rendering_val"]
    counts = [sum(n.endswith("_vis.png") for n in os.listdir(os.path.join(tmp, "rendered_val", d)))
              for d in ("rendering_fake", "rendering_real")]
    if counts != [rendered, rendered] or not rendered:
        raise AssertionError(f"rendering_val: {rendered} reported, fake/real banners {counts}")
    rec = dict(runs=out, launches=launches, launches_expected=want, forwards=forwards,
               rendered=rendered, peak_memory_gb=peak_gb, wall_s=wall_s,
               inception_images_per_s=timing["inception_images"] / timing["inception_s"],
               inception_images=timing["inception_images"],
               compositing_ms_per_image=1e3 * timing["compositing_s"] / timing["composited"],
               composited=timing["composited"])
    for tag, r in out.items():
        log(f"evaluation ({tag}) {r['ckpt']} on {r['items']} val items, batch {args.batch}: "
            + ", ".join(f"{k} {v:.5g}" for k, v in r["values"].items()))
        log(f"  total_time (s): " + ", ".join(f"{k} {v:.2f}" for k, v in r["total_time_s"].items())
            + f"; {r['layouts_per_s']:.1f} layouts/s generated ({r['forwards']} G_ema forwards, "
              f"host clock around each batch)  [{card}]")
    log(f"evaluation: InceptionV3 {rec['inception_images_per_s']:.1f} images/s "
        f"({rec['inception_images']} 1024^2 composites: upload, resize, network), host compositing "
        f"{rec['compositing_ms_per_image']:.2f} ms an image; {rendered} banners rendered (fake = real); "
        f"peak memory {peak_gb:.2f} GiB; wall {wall_s:.1f} s; launches {launches} = 12 x {forwards} "
        f"G_ema forwards  [{card}]")
    rec["card_vs_cpu"] = features_card_vs_cpu(torch, np, args, val_path, t, inc_path)
    return rec


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description="Run the port's main paths on one GPU.")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=16, help="requests per served batch, train batch")
    ap.add_argument("--bias-act-only", action="store_true",
                    help="run phases 1-3 for bias_act alone, with where a call's host time "
                         "goes, and print their JSON; prints no ok line")
    ap.add_argument("--attention-only", action="store_true",
                    help="run phases 1-3 for fused_attention alone, with where a call's host "
                         "time goes, and print their JSON; prints no ok line")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    if args.bias_act_only:
        return bias_act_only(torch, args)
    if args.attention_only:
        return attention_only(torch, args)

    from layoutdetr_tpu_torch.config import GeneratorConfig
    from layoutdetr_tpu_torch.generate import generate_layouts
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

    # the training run's dataset, made first: its --max-text-length auto
    # bucket sets the run's attention shapes, which phase 3 checks
    workdir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    zip_path, val_path, run_t = run_dataset(workdir.name, args.seed)
    log(f"training-run dataset: {RUN_SAMPLES} samples (and a val.zip of as many), "
        f"--max-text-length auto -> T={run_t}")

    # 3. kernels vs plain
    shapes = list(dict.fromkeys(serving_attention_shapes(args.batch)
                                + run_attention_shapes(args.batch, run_t)
                                + eval_attention_shapes(args.batch, run_t)))
    attn_cases = attention_phase(torch, attention, args.seed, shapes)
    cfg = GeneratorConfig()
    torch.manual_seed(args.seed)
    with torch.device("cuda"):
        model = Generator(cfg).eval()
    calls, disc = bg_decoder_calls(torch, cfg, args.batch)
    states = (model.state_dict(), {k: v.clone() for k, v in disc.state_dict().items()})
    del disc
    bias_cases = bias_act_phase(torch, bias_act_mod, calls, args.seed)
    round_trip = round_trip_phase(torch, bias_act_mod, calls, args.seed)
    backward_kernels = kernels_per_backward(torch, bias_act_mod, calls)

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
    want = dict(fused_attention=forwards * cfg.bert_num_encoder_layers, fused_attention_dropout=0,
                bias_act=0, bias_act_backward=0)
    if counters(attention, bias_act_mod) != want:
        raise AssertionError(f"serving launched {counters(attention, bias_act_mod)} in {forwards} "
                             f"forwards, expected {want}")
    log(f"main path (serving): {forwards} served batches, fused_attention launched {serve_launches} times")

    # 6. the forward alone, outside the counted run: time and device profile
    forward_phase(torch, variants, serving, np, args, card)
    del variants
    torch.cuda.empty_cache()

    # 7. train step, slice 2's main path
    train = train_phase(torch, np, cfg, states, args, card, attention, bias_act_mod)

    # 8. step correctness
    correctness = step_correctness_phase(torch, np, cfg, states, args, attention, bias_act_mod)
    del states
    torch.cuda.empty_cache()

    # 9. the training run, slice 3's main path
    run = training_run_phase(torch, np, args, card, attention, bias_act_mod, workdir.name,
                             zip_path, run_t)

    # 10. evaluation, slice 4's main path
    evaluation = evaluation_phase(torch, np, args, card, attention, bias_act_mod, workdir.name,
                                  run["snapshot"], val_path, run_t)
    workdir.cleanup()

    kernels = kernel_records(attn_cases, bias_cases, serve_launches, train, run, evaluation)
    log(json.dumps({"serving": serving, "train": train, "step_correctness": correctness,
                    "training_run": run, "evaluation": evaluation,
                    "model_max_abs": err, "model_bf16_max_abs": err_bf16,
                    "model_bf16_vs_fp32_max_abs": err_bf16_fp32, "cpu_max_abs": err_cpu,
                    "attention_cases": attn_cases, "bias_act_cases": bias_cases,
                    "bias_act_round_trip": round_trip,
                    "bias_act_kernels_per_backward": backward_kernels,
                    "bias_act_largest_lrelu": largest_lrelu(bias_cases),
                    "build_s": build_s, "wall_s": time.perf_counter() - t_start}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


def bg_decoder_calls(torch, cfg, batch: int) -> list:
    """The arguments of the 48 bias_act calls of one bg_decoder forward at
    full width (seeded random weights)."""
    from layoutdetr_tpu_torch.models.discriminator import Discriminator
    from layoutdetr_tpu_torch.ops import bias_act as bias_act_mod

    with torch.device("cuda"):
        disc = Discriminator(cfg)
    calls = []
    x0 = torch.randn(batch, cfg.hidden_dim, device="cuda")
    with recorded_bias_act_calls(bias_act_mod, calls), torch.no_grad():
        disc.bg_decoder(x0)
    if len(calls) != 48:
        raise AssertionError(f"{len(calls)} bias_act calls in one bg_decoder forward, expected 48")
    return calls, disc


def bias_act_only(torch, args) -> int:
    """Phases 1-3 for bias_act alone: build, each call of a step vs the
    plain version, the round trip, one launch a backward, where a call's
    host time goes; one JSON line."""
    from layoutdetr_tpu_torch.config import GeneratorConfig
    from layoutdetr_tpu_torch.ops import _build
    from layoutdetr_tpu_torch.ops import bias_act as bias_act_mod

    card = nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | tree {ROOT}")
    t0 = time.perf_counter()
    _build.build("bias_act")
    log(f"build bias_act.cu: {time.perf_counter() - t0:.2f} s")
    torch.manual_seed(args.seed)
    calls, disc = bg_decoder_calls(torch, GeneratorConfig(), args.batch)
    del disc
    cases = bias_act_phase(torch, bias_act_mod, calls, args.seed)
    round_trip = round_trip_phase(torch, bias_act_mod, calls, args.seed)
    backward_kernels = kernels_per_backward(torch, bias_act_mod, calls)
    host = host_costs(torch, bias_act_mod)
    totals = {d: per_step_totals(cases, d) for d in ("float32", "bfloat16")}
    for d, t in totals.items():
        log(f"bias_act per step {d}: forward {t['fwd_ms']:.4f} ms (bound {t['fwd_bound_ms']:.4f}), "
            f"backward {t['bwd_ms']:.4f} ms (bound {t['bwd_bound_ms']:.4f}); the "
            f"{t['library_calls']} linear calls {t['fwd_ms_library_calls']:.4f} / "
            f"{t['bwd_ms_library_calls']:.4f} ms vs torch.add {t['library_fwd_ms']:.4f} / "
            f"torch.sum {t['library_bwd_ms']:.4f} ms")
    log(json.dumps({"tree": ROOT, "card": card, "per_step": totals,
                    "largest_lrelu": largest_lrelu(cases), "round_trip": round_trip,
                    "kernels_per_backward": backward_kernels, "host": host, "cases": cases}))
    return 0


def attention_only(torch, args) -> int:
    """Phases 1-3 for fused_attention alone: build, the 8 cases vs the
    plain version and sdpa, where a call's host time goes; one JSON line."""
    from layoutdetr_tpu_torch.ops import _build, attention

    card = nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | tree {ROOT}")
    t0 = time.perf_counter()
    lib = _build.build("attention")
    log(f"build attention.cu: {time.perf_counter() - t0:.2f} s")
    with open(lib + ".log") as f:
        log(f.read().strip())
    cases = attention_phase(torch, attention, args.seed, serving_attention_shapes(args.batch))
    host = attention_host_costs(torch, attention)
    log(json.dumps({"tree": ROOT, "card": card, "host": host, "cases": cases}))
    return 0


def largest_lrelu(cases: list) -> dict:
    """The largest lrelu call per dtype: times, bounds and the share of the
    bound reached (bound / time)."""
    out = {}
    for d in ("float32", "bfloat16"):
        r = max((c for c in cases if c["dtype"] == d and c["act"] == "lrelu"),
                key=lambda c: math.prod(c["shape"]))
        out[d] = dict(shape=r["shape"], fwd_ms=r["fwd_ms"], fwd_bound_ms=r["fwd_bound_ms"],
                      fwd_share=r["fwd_bound_ms"] / r["fwd_ms"], bwd_ms=r["bwd_ms"],
                      bwd_bound_ms=r["bwd_bound_ms"], bwd_share=r["bwd_bound_ms"] / r["bwd_ms"])
    return out


def kernel_records(attn_cases, bias_cases, serve_launches: int, train: list, run: dict,
                   evaluation: dict) -> list:
    """The kernels line: each kernel at its representative case (fp32,
    T=256 for attention; one fp32 step's 48 bias_act calls summed), with
    the launches of each main path that runs it (``launches_by_path``) and
    their sum. Attention's two forms count apart: the dropout form under
    fused_attention_dropout (the train step's and the training run's main
    steps), the deterministic one under fused_attention (serving, the
    training run's reg steps, summaries, previews and metric ticks, and the
    evaluation)."""
    def attn(rate):
        return next(c for c in attn_cases if c["dtype"] == "float32" and c["shape"][2] == 256
                    and c["dropout_rate"] == rate)

    by_path = {"fused_attention": dict(serving=serve_launches)}
    for k in ("fused_attention", "fused_attention_dropout", "bias_act", "bias_act_backward"):
        by_path.setdefault(k, {})
        train_launches = sum(r["launches"][k] for r in train)
        if train_launches:
            by_path[k]["train_step"] = train_launches
        by_path[k]["training_run"] = run["launches"][k]
    by_path["fused_attention"]["evaluation"] = evaluation["launches"]["fused_attention"]
    src = "layoutdetr_tpu_torch/ops/csrc/"
    out = []
    for name, rate in (("fused_attention", 0.0), ("fused_attention_dropout", DROPOUT)):
        c = attn(rate)
        out.append(dict(name=name, route="cuda", source=src + "attention.cu",
                        replaces="layoutdetr_tpu/ops/attention.py:98",
                        launches=sum(by_path[name].values()), launches_by_path=by_path[name],
                        max_abs_err=c["max_abs_err"], ms=c["ms"], plain_ms=c["plain_ms"],
                        bound_ms=c["bound_ms"], bound_by=c["bound_by"], library_ms=c["library_ms"],
                        cases=[x for x in attn_cases if x["dropout_rate"] == rate]))
    tot = per_step_totals(bias_cases, "float32")
    tot16 = per_step_totals(bias_cases, "bfloat16")
    for name, key in (("bias_act", "fwd"), ("bias_act_backward", "bwd")):
        out.append(dict(name=name, route="cuda", source=src + "bias_act.cu",
                        replaces="layoutdetr_tpu/ops/bias_act.py:145",
                        launches=sum(by_path[name].values()), launches_by_path=by_path[name],
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
