#!/usr/bin/env python3
"""Run the PyTorch port's main paths on one NVIDIA GPU and hold every
kernel on them against its plain version.

    python3 chip_smoke.py [--seed 0] [--batch 16]
    python3 chip_smoke.py --bias-act-only
    python3 chip_smoke.py --attention-only
    python3 chip_smoke.py --bench-host-only
    python3 chip_smoke.py --multi-card

The second form runs phases 1-3 for bias_act alone, adds where a call's
host time goes (two ways to read the current stream, the host us of a
call beside torch.add / torch.sum / empty_like), and prints one JSON line
and no ok line. The third does the same for fused_attention: its 8 cases,
and the host us of a call at [18, 4, 64, 192] bf16 beside sdpa's, split
into plan and checks, empty_like, the per-call tensor-map encoding, a bare
ctypes call and the stream read. The fourth runs the bench's train step
beside phase 7's in one process (bf16, T=256, batch 16): each step's host
time to return from the call and to the end of a synchronize after it, a
12-step window of each in the order A, B, B, A, and one profiled step of
each (device busy ms, kernel launches, and the count and host ms of
``aten::item``, ``cudaLaunchKernel`` and the other host calls that can
hold a step); one JSON line and no ok line. The fifth needs several
cards: ``python -m layoutdetr_tpu_torch.train --gpus N`` over every
visible card (NCCL, one process a card) on phase 9's zip, data parallel
and with ``--model-parallel 2``, then the multi-host form, two torchrun
"nodes" of half the cards each (``--nnodes 2``, ``CUDA_VISIBLE_DEVICES``
splitting the cards) beside ``--gpus N``, each served from once; one
JSON line and no ok line. The default one-card run cannot hold two NCCL
ranks on one device, so it does not run the multi-host form.

Phases (any failure ends the run with a non-zero exit and no result):

1. device: name and power limit (nvidia-smi);
2. build: the CUDA kernels from the sources in this checkout (nvcc,
   sm_90a) and the host decoder ``data/csrc/fastdata.cpp`` (g++), one
   compiler per source, all started together, timed;
3. kernels: each kernel vs its plain PyTorch version at the main paths'
   shapes, with its time, the plain version's, one PyTorch library call's
   and the card's bound:
   - fused_attention [rows, 4, T, 192] at every shape of the main paths:
     serving and the train step (rows B*9, T in {256, 64}), the training
     run at its auto bucket T (16 on its zip, a partial 64-key chunk):
     rows B*9 (main and R1 steps, the metric ticks), (B/2)*9 (path
     length), 9 (module summaries, the served request) and 36 (image
     snapshot), the evaluation (rows B*9 and the last partial batch's,
     at T=16 and T=256), the HTTP server (rows 5*9 = 45 at T=256; the
     bench's shapes are the train step's and serving's; the ViT's, phase
     13, are serving's, the train step's and the training run's),
     LayoutGAN++ (phase 14: rows B*9 and a partial batch's 7*9 at T=40)
     and phase 17 (``entry()``: rows 36 at T=64; a dry-run rank: rows 6
     at T=8, one head of 192, the dropout form; the closure's digest
     forward: rows 36 at T=256);
     fp32 and bf16, key padding down to length 2;
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
     (profiled); and the same forward and backward checks at every
     distinct call of a full-width LayoutGAN++ D's StyleGAN2 ``bg_encoder``
     forward at batch 16 (22 calls: lrelu from [16, 32, 256, 256] down to
     [16, 512, 4, 4], the bias-less linear skips at gain sqrt(1/2), the
     lrelu and linear FCs [16, 512]); and at every call of a dry-run
     rank's bg_decoder (phase 17: D at ``graft_entry.DRYRUN_CONFIG``,
     32^2, 2 samples);
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
   host compositing ms an image and peak memory;
11. HTTP serving (slice 5's serving path): the port's stdlib server
   (``serving.api_server.make_server``) in a thread on 127.0.0.1, on phase
   10 (b)'s full-width fp32 ``save_generator`` file (T=256): POST /upload
   of a 1024^2 PNG, two POST /prediction of 5 banners (1-9 and 9 elements)
   with the launch counts set to 0 before each and read after (12
   deterministic attention launches each), POST /update on a returned
   page, GET and POST /save, an unknown route (404). Checks: one
   checkpoint load, 5 seeds ranked by ascending overlap, every image and
   HTML file written. Printed: each request's host latency split into the
   forward (CUDA events), the rendering (host clock around
   ``visualize_banner``) and the rest;
12. the bench (slice 5's measurement path): ``python -m
   layoutdetr_tpu_torch.bench`` through ``bench.main`` with its defaults
   (bf16, T=256, batch 16, 2 + 6 + 24 steps), then ``--infer``, with the
   launch counts set to 0 before and read after each: 12 dropout attention
   and 48 + 48 bias_act launches a step (and 48 + 48 in its FLOP-count
   step, which runs plain attention), 12 deterministic attention launches
   a forward. Each JSON line is parsed and printed; FLOPs an image (beside
   JAX's 1.932e12), MFU against the H100's peak and peak memory;
13. the ViT backbone (slice 6), ``GeneratorConfig(backbone="vit")`` at full
   width (ViT-B/16, a 16 x 16 DETR memory), weights from --seed: (a) the
   serving forward at T=256, fp32 and bf16, kernels vs plain attention,
   bf16 vs fp32, card vs CPU (B=1, T=64), then ``generate_layouts``
   batches with the counts from 0 (12 launches a forward), requests/s and
   forward ms; (b) phase 7's bf16 T=256 train step (counted: 12 + 48 + 48
   launches a step; step time, peak memory, one profiled step) and phase
   8's deterministic fp32 steps (kernels vs plain, card vs CPU); (c)
   ``train.main --backbone vit`` for 2 steps on phase 9's zip (bf16, auto
   T, R1 and path length at step 0, a snapshot), then ``evaluate.main`` on
   that snapshot (layout FID on 64 val items), counted from the run's start
   to the evaluation's end;
14. LayoutGAN++ (slice 6), ``LayoutGanPPConfig()`` at full width (BERT 768
   x 12, 8 layers of 512, StyleGAN2 encoder and decoder at 256^2, T=40),
   weights from --seed, fp32 and bf16, with the counts from 0: G forwards
   at batch 16 and at a partial batch of 7, D(reconst=True) forwards (12
   attention launches each, 22 bias_act an encoder and 48 a decoder), D
   forward and backward of a fixed scalar of its outputs (its text pass
   then runs plain attention); outputs and D's gradient with the kernels
   vs with plain attention and plain bias_act, the card vs the CPU (fp32,
   B=2), and each call's time.
15. multi-GPU training (slice 7), at full width on the one card: two
   ranks over gloo on cuda:0 (``parallel.distributed.spawn``; NCCL refuses
   two ranks on one device): (a) data parallel 2 x 1 and (b) tensor
   parallel 1 x 2 (BERT's q/k/v, FFN and the transformers' linear1/linear2
   sharded), each one deterministic fp32 step at batch 16 (T=256, phase
   8's batch and z, each rank its share) held to the one-process step at
   phase 8's bars, with the replica check and 12 + 48 + 48 launches a
   rank; (a) also 3 bf16 steps with dropout (per-rank step ms and peak
   memory: two ranks sharing one card say nothing of scaling); (c)
   ``training_loop`` over the 2 ranks on phase 9's zip (bf16, ADA, path
   length at steps 0 and 4, R1 at 0, a snapshot each tick with the
   replica check), 6 steps and a 2-step resume from its snapshot, one p
   and one pl_mean on both ranks, each rank's launches counted, then
   ``generate --ckpt`` from the snapshot; (d) one fp32 step through an
   NCCL group of one rank, equal bit for bit to the step without a group
   (cuDNN deterministic for both).
16. the host data path (slice 8): a source tree of 16 banner pages
   (PIL, 15 banner sizes up to 1024 px, 1-9 elements) through ``python -m
   layoutdetr_tpu_torch.dataset_tool`` (made before phase 3, whose
   attention shapes include this run's auto T; pages, zip bytes and
   seconds printed); every background of its zips decoded by phase 2's
   fastdata against PIL (decode exact, Lanczos to 256^2 within 1 level,
   mean under 0.01); the ms a background (1024^2 -> 256^2) and
   ``warm_cache`` seconds native and PIL on the host clock, with the
   derived figure for the reference's 7,672 pages; then ``train.main
   --device-feed off --batch 16 --bf16 --max-text-length auto`` for 4 steps
   on the tool's train.zip, its host loader decoding natively (checked),
   and one request served from its snapshot, with the launch counts set to
   0 before the run and read after the request (12 + 48 + 48 a step, 12
   deterministic a summary forward, image snapshot and request, 48 forward
   in D's summary).
17. the driver hooks and the reference closure: (a)
   ``graft_entry.entry()`` on the card (``GeneratorConfig()``, b=4, T=64),
   its ``fn`` counted once (12 attention launches) and timed (CUDA
   events), against the same weights with plain attention (phase 4's bar)
   and on the CPU (phase 4's card-vs-CPU bar); (b)
   ``graft_entry.dryrun_multichip(8)`` in a process of its own, as a
   driver calls it: 8 ranks over gloo sharing the card (NCCL when 8 cards
   are visible), one train step each, the OK line, each rank's launches
   from its own file (1 dropout attention launch and the bg_decoder's
   bias_act forward and backward a rank), wall time and rank 0's peak
   memory; (c) ``python -m layoutdetr_tpu_torch.verify_reference --dry-run``
   through ``verify_reference.main`` at full width: a ``GeneratorConfig()``
   snapshot pickle (its size printed, deleted after), a val.zip of 40
   items, the chain's three steps with their seconds, 12 attention
   launches a G_ema forward (the digest's and the evaluation's), the
   digest forward against the CPU on the same pickle and z, finite
   metrics and the report. The phase's wall is printed.

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
# A gradient through lrelu is discontinuous at 0: where the card and the
# CPU round a pre-activation to opposite sides of the kink (|z| within
# fp32 rounding), that element's slope differs (0.2 against 1), and every
# gradient upstream of it moves by its share of the flow: one element of
# a [2, 512] mapping layer is ~1e-3 of it. So a gradient compared across
# devices is held to CPU_TOL where no lrelu input changed side, else to
# this (a wrong layout or a missing term moves it by O(1)).
KINK_GRAD_TOL = 1e-2
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
SERVE_RESULTS = 5  # banners a /prediction (the JAX server's default numResults), phase 11
SUITE = "overlap50k_alignment50k_layoutwise_iou50k_layoutwise_docsim50k_val"
TRAIN_VARIANTS = (("bfloat16", 256), ("float32", 256), ("bfloat16", 64))
RANGES = ("train_step.", "Optimizer.")  # profiler range names, not kernels
# host calls counted in --bench-host-only's profiled steps
HOST_CALLS = ("aten::item", "aten::_local_scalar_dense", "cudaLaunchKernel", "cuLaunchKernelEx",
              "cudaMemcpyAsync", "cudaStreamSynchronize", "cudaDeviceSynchronize")


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


def layoutganpp_attention_shapes(batch: int) -> list:
    """(rows, T) of phase 14's attention calls: LayoutGAN++'s frozen text
    pass at T=40, ``batch`` samples and the partial batch of LGPP_PARTIAL."""
    return [(batch * 9, 40), (LGPP_PARTIAL * 9, 40)]


def run_attention_shapes(batch: int, t: int) -> list:
    """(rows, T) of every attention call of the training run (phase 9) at
    its bucket T: the main and R1 steps and the metric ticks (batch * 9
    texts), the path-length step (batch // 2 samples), the module
    summaries and the request served from the snapshot (1 sample), and the
    image snapshot (4 samples)."""
    return [(batch * 9, t), (max(batch // 2, 1) * 9, t), (9, t), (4 * 9, t)]


def multi_gpu_attention_shapes(batch: int) -> list:
    """(rows, T[, heads, head_offset]) of phase 15's attention calls beside
    the training run's: a data-parallel rank's step at T=256 (half the
    batch), a tensor-parallel rank's (the batch, its 2 heads with the
    dropout key's offset: heads 0-1 and 2-3 of 4) and the NCCL step (2
    samples at T=64)."""
    return [((batch // 2) * 9, 256), (batch * 9, 256, 2, 0), (batch * 9, 256, 2, 2), (2 * 9, 64)]


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
    """Kernel vs plain at each (rows, T) of ``shapes``, [rows, 4, T, 192]
    (or (rows, T, heads, head_offset): a tensor-parallel rank's heads of
    4; or (rows, T, heads, head_offset, total heads)), fp32 and bf16,
    without and with dropout; one record per case."""
    import torch.nn.functional as F

    d = 192
    scale = d ** -0.5
    cases = []
    for rate in (0.0, DROPOUT):
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            esize = torch.finfo(dtype).bits // 8
            for b, t, h, offset, total in ((*s, 4, 0, 4)[:5] for s in shapes):
                heads = dict(head_offset=offset, total_heads=total)
                g = torch.Generator(device="cuda").manual_seed(seed + t + b)
                # [B, T, H, D] projections viewed as [B, H, T, D], as BERT gives them
                q, k, v = (torch.randn(b, t, h, d, device="cuda", generator=g).to(dtype)
                           .transpose(1, 2) for _ in range(3))
                lens = torch.randint(2, t + 1, (b,), device="cuda", generator=g)
                lens[0], lens[1] = 2, t
                bias = torch.where(torch.arange(t, device="cuda")[None] < lens[:, None], 0.0, -10000.0)
                drop = dict(dropout_rate=rate, seed=seed + 7 if rate else None)

                out = attention.fused_attention(q, k, v, bias, scale=scale, **drop, **heads)
                torch.cuda.synchronize()
                mask = (attention.keep_mask(seed + 7, b, h, t, rate, device="cuda", **heads)
                        if rate else None)
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
                                                                      **drop, **heads), 20)

                def plain():
                    m = (attention.keep_mask(seed + 7, b, h, t, rate, device="cuda", **heads)
                         if rate else None)
                    return attention.attention_ref(q, k, v, bias, scale, rate, m)

                plain_ms = cuda_ms(torch, plain, 5)
                amask = bias.to(dtype)[:, None, None, :]
                library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=amask, scale=scale, dropout_p=rate), 20)
                flops = 4.0 * b * h * t * t * d
                nbytes = 4.0 * b * h * t * d * esize + b * t * 4
                bound_ms, bound_by = bound(flops, nbytes, dtype_name)
                rec = dict(dtype=dtype_name, shape=[b, h, t, d], head_offset=offset,
                           dropout_rate=rate, max_abs_err=err,
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


def bias_act_phase(torch, bias_act_mod, calls: list, seed: int, per: str = "step") -> list:
    """Forward and backward kernels vs the plain versions at each distinct
    call of ``calls`` (one step's bg_decoder forward, or one LayoutGAN++
    bg_encoder forward with ``per="encoder forward"``); one record per
    (call, dtype) with the number of times a step (or ``per``) makes that
    call. b is in x's dtype, as
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
            # backward's db one sum of dy (dx is dy itself). A linear call with
            # another gain (the encoder's bias-less skip, gain sqrt(1/2)) has
            # one forward, torch.add(gain * b, x, alpha=gain) with gain * b
            # ([C]) made beforehand, and no single backward call (dx = gain *
            # dy and db). The lrelu calls have no such call.
            pass_through = act == "linear" and gain == 1.0 and clamp is None
            lib_fwd = lib_bwd = lib_err = None
            if act == "linear" and clamp is None:
                others = [i for i in range(len(shape)) if i != dim]
                gbview = bview * gain

                def lib_call():
                    return torch.add(x, bview) if pass_through else torch.add(gbview, x, alpha=gain)

                lib_err = ((lib_call().float() - want_y).abs().max().item()
                           / max(want_y.abs().max().item(), 1e-30))
                if dtype_name == "float32" and not lib_err <= tol_y:  # the same fp32 add
                    raise AssertionError(f"torch.add vs bias_act_ref {shape}: {lib_err}")
                lib_fwd = cuda_ms(torch, lib_call, 20)
                if pass_through:
                    lib_bwd = cuda_ms(torch, lambda: torch.sum(dy, dim=others, dtype=torch.float32),
                                      20)
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
            lib = ("none" if lib_fwd is None else f"torch.add {lib_fwd * 1e3:.1f} us / " + (
                "none" if lib_bwd is None else f"torch.sum {lib_bwd * 1e3:.1f} us"))
            log(f"bias_act {dtype_name} {list(shape)} {act} gain {gain:.4g} x{per_step}/{per}: rel err y "
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
    autograd, and against ``x + b`` alone, at [batch, 512] linear and at
    the largest lrelu call of ``calls`` (one batch's); b in x's dtype, as the models pass it."""
    import torch.nn.functional as F

    lrelu = max((c for c in calls if c[2] == "lrelu"), key=lambda c: math.prod(c[0]))
    fc = next(c for c in calls if len(c[0]) == 2 and c[0][1] == 512 and c[2] == "linear")
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
    call (library_calls of them have one forward; a linear call with a gain
    other than 1 has none backward), the kernel's time beside the
    library's."""
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
            if r[f"library_{key}_ms"] is not None:
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


def train_phase(torch, np, cfg, states, args, card, attention, bias_act_mod,
                variants=TRAIN_VARIANTS) -> list:
    """The main path of slice 2: per (dtype, T) of ``variants``, counts from
    0, 1 warm-up, 3 timed and 1 profiled step, counts read after."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    results = []
    for dtype_name, t in variants:
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
        log(f"train {cfg.backbone} {dtype_name} T={t} batch {args.batch}: step {step_ms:.1f} ms (median) "
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
              "--seed", str(args.seed), "--snap", "1", "--gpus", "1"]  # one process on any host
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
               rendered=rendered, peak_memory_gb=peak_gb, wall_s=wall_s, wide_ckpt=wide_path,
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
# 11. HTTP serving
# ---------------------------------------------------------------------------

def http_attention_shapes() -> list:
    """(rows, T) of the server's attention calls (phase 11): one forward of
    SERVE_RESULTS seeds of 9 elements at T=256."""
    return [(SERVE_RESULTS * 9, 256)]


def http_json(url: str, body=None) -> tuple:
    """(status, parsed JSON or None) of a JSON POST, or a GET when ``body``
    is None; an HTTP error status comes back, it does not raise."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        e.read()
        return e.code, None


def banner_background(np, size: int, seed: int) -> bytes:
    """A PNG of a ``size`` x ``size`` background: colour ramps, blocks and noise."""
    import io

    import PIL.Image

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size] / size
    img = np.stack([x, y, 0.5 + 0.5 * np.sin(6 * x + 4 * y)], axis=-1) * 255
    for _ in range(6):
        r0, c0 = rng.integers(0, size * 3 // 4, size=2)
        img[r0:r0 + size // 4, c0:c0 + size // 4] = rng.integers(0, 256, size=3)
    img = np.clip(img + rng.normal(scale=8, size=img.shape), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    PIL.Image.fromarray(img).save(buf, "PNG")
    return buf.getvalue()


@contextlib.contextmanager
def timed_server(torch, api_server, seen: dict):
    """Inside, the server's checkpoint loads are counted (``loads``), each
    loaded model's forwards timed by CUDA events (``forward_ms``, read
    after a sync) and its ``visualize_banner`` calls on the host clock
    (``render_s``)."""
    real_load, real_vis = api_server.load_generator_checkpoint, api_server.visualize_banner
    seen.update(loads=[], events=[], render_s=0.0)

    def load(ckpt, *a, **k):
        model = real_load(ckpt, *a, **k)
        seen["loads"].append(ckpt)

        def pre(module, inputs):
            seen["events"].append([torch.cuda.Event(enable_timing=True) for _ in range(2)])
            seen["events"][-1][0].record()

        model.register_forward_pre_hook(pre)
        model.register_forward_hook(lambda module, inputs, out: seen["events"][-1][1].record())
        return model

    def vis(*a, **k):
        t0 = time.perf_counter()
        out = real_vis(*a, **k)
        seen["render_s"] += time.perf_counter() - t0
        return out

    api_server.load_generator_checkpoint, api_server.visualize_banner = load, vis
    try:
        yield seen
    finally:
        api_server.load_generator_checkpoint, api_server.visualize_banner = real_load, real_vis


def http_serving_phase(torch, np, args, card, attention, bias_act_mod, tmp: str, ckpt: str) -> dict:
    """Slice 5's serving path: the port's stdlib HTTP server in a thread on
    127.0.0.1 (a free port), on phase 10 (b)'s full-width fp32
    ``save_generator`` file (T=256). POST /upload of a 1024^2 PNG, two
    /prediction requests of SERVE_RESULTS banners (1-9 elements each) with
    the launch counts set to 0 before each and read after, /update on a
    returned page, GET and POST /save, and an unknown route."""
    import base64
    import threading

    from layoutdetr_tpu_torch.serving import api_server

    cfg = api_server.ServerConfig(ckpt, "cuda", torch.float32,
                                  upload_dir=os.path.join(tmp, "uploads"),
                                  generated_dir=os.path.join(tmp, "generated"))
    api_server._MODEL_CACHE.clear()
    server = api_server.make_server(cfg, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    rng = np.random.default_rng(args.seed)
    requests_out = []
    with timed_server(torch, api_server, {}) as seen:
        thread.start()
        try:
            png = banner_background(np, 1024, args.seed)
            status, up = http_json(url + "/upload", {"image": base64.b64encode(png).decode()})
            if status != 200:
                raise AssertionError(f"/upload answered {status}")
            for k in (int(rng.integers(1, 10)), 9):
                elements = [{"text": " ".join(rng.choice(WORDS, size=int(rng.integers(1, 8)))),
                             "type": LABELS[int(i)]} for i in rng.integers(0, len(LABELS), size=k)]
                body = {"imageId": up["imageId"], "numResults": SERVE_RESULTS,
                        "contentStyle": {"elements": elements}}
                render0, events0 = seen["render_s"], len(seen["events"])
                zero_counters(attention, bias_act_mod)
                t0 = time.perf_counter()
                status, pred = http_json(url + "/prediction", body)
                latency_s = time.perf_counter() - t0
                launches = counters(attention, bias_act_mod)
                torch.cuda.synchronize()
                if status != 200 or len(seen["events"]) != events0 + 1:
                    raise AssertionError(f"/prediction answered {status}; "
                                         f"{len(seen['events']) - events0} forwards")
                start, end = seen["events"][-1]
                forward_ms = start.elapsed_time(end)
                results = pred["results"]
                overlaps = [r["overlap"] for r in results]
                want = dict(fused_attention=12, fused_attention_dropout=0, bias_act=0,
                            bias_act_backward=0)
                if (launches != want or len(results) != SERVE_RESULTS
                        or sorted(r["seed"] for r in results) != list(range(1, SERVE_RESULTS + 1))
                        or overlaps != sorted(overlaps) or not all(map(math.isfinite, overlaps))
                        or not all(os.path.exists(r["image"]) and os.path.exists(r["html"])
                                   for r in results)):
                    raise AssertionError(f"/prediction with {k} elements: launches {launches}, "
                                         f"results {results}")
                rec = dict(elements=k, results=SERVE_RESULTS, latency_ms=1e3 * latency_s,
                           forward_ms=forward_ms, render_ms=1e3 * (seen["render_s"] - render0),
                           launches=launches, overlaps=overlaps)
                rec["rest_ms"] = rec["latency_ms"] - rec["forward_ms"] - rec["render_ms"]
                requests_out.append(rec)
                log(f"http /prediction ({k} elements, {SERVE_RESULTS} banners, fp32 T=256): host "
                    f"latency {rec['latency_ms']:.1f} ms = forward {forward_ms:.1f} ms (CUDA "
                    f"events) + rendering {rec['render_ms']:.1f} ms (PIL, {SERVE_RESULTS} banners: "
                    f"image and HTML) + the rest {rec['rest_ms']:.1f} ms (load on the first, "
                    f"decode, tokenize, post-processing, JSON); overlaps "
                    f"{', '.join(f'{v:.4f}' for v in overlaps)}; launches {launches}  [{card}]")
            html = results[0]["html"]
            with open(html) as f:
                doc = f.read()
            status, upd = http_json(url + "/update", {"editedHTMLs": [
                {"htmlName": os.path.basename(html), "htmlContent": doc}]})
            vis_png = html[:-len(".html")] + "_vis.png"
            if status != 200 or upd["updatedStatus"][0]["status"] != "success" \
                    or not os.path.exists(vis_png):
                raise AssertionError(f"/update answered {status}: {upd}")
            saves = [http_json(url + "/save"), http_json(url + "/save", {})]
            if saves != [(200, {"status": "success"})] * 2:
                raise AssertionError(f"/save answered {saves}")
            unknown = http_json(url + "/no-such-route", {})[0]
            if unknown != 404:
                raise AssertionError(f"an unknown route answered {unknown}")
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
    if thread.is_alive() or seen["loads"] != [ckpt]:
        raise AssertionError(f"server thread alive {thread.is_alive()}, loads {seen['loads']}")
    api_server._MODEL_CACHE.clear()
    torch.cuda.empty_cache()
    log(f"http serving: /upload (1024^2 PNG), 2 x /prediction from one load, /update (PIL "
        f"re-render), GET and POST /save, 404 on an unknown route")
    return dict(requests=requests_out, loads=len(seen["loads"]),
                launches=sum(r["launches"]["fused_attention"] for r in requests_out))


# ---------------------------------------------------------------------------
# 12. the bench
# ---------------------------------------------------------------------------

BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "baseline_source", "value_sustained",
              "value_burst", "vs_baseline_burst")


def bench_phase(torch, args, card, attention, bias_act_mod) -> dict:
    """``python -m layoutdetr_tpu_torch.bench`` through ``bench.main`` with
    its defaults (bf16, T=256, batch 16, 2 warm-up + 6 burst + 24 sustained
    steps), then ``--infer``; counts from 0 before each, read after: 12
    attention launches with dropout and 48 + 48 bias_act a timed step (and
    48 + 48 in the FLOP-count step, whose attention is plain); 12
    deterministic attention launches a timed forward."""
    import io

    from layoutdetr_tpu_torch import bench

    out = {}
    for tag, extra in (("train", []), ("infer", ["--infer"])):
        zero_counters(attention, bias_act_mod)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = bench.main(["--device", "cuda", "--seed", str(args.seed), *extra])
        wall_s = time.perf_counter() - t0
        launches = counters(attention, bias_act_mod)
        lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
        if len(lines) != 1:
            raise AssertionError(f"bench {tag}: stdout {lines}")
        line = json.loads(lines[0])
        calls = res["calls"]
        timed = calls["warmup"] + calls["burst"] + calls["sustained"]
        if tag == "train":
            want = dict(fused_attention=0, fused_attention_dropout=12 * timed,
                        bias_act=48 * (timed + 1), bias_act_backward=48 * (timed + 1))
        else:
            want = dict(fused_attention=12 * timed, fused_attention_dropout=0, bias_act=0,
                        bias_act_backward=0)
        if (tuple(line) != BENCH_KEYS or line != res["line"] or line["unit"] != "imgs/sec/chip"
                or not line["value"] == line["value_sustained"] > 0
                or line["baseline_source"] != "derived" or launches != want):
            raise AssertionError(f"bench {tag}: {line}, launches {launches}, expected {want}")
        log(lines[0])
        jax_flops = bench.JAX_TRAIN_FLOPS_PER_IMG  # XLA's count, bf16 T=256
        ratio = res["flops_per_img"] / jax_flops
        log(f"bench {tag} {res['dtype']} T={res['T']} batch {res['batch']}: {line['value']:.2f} "
            f"images/s sustained, {line['value_burst']:.2f} burst; "
            f"FLOPs/img {res['flops_per_img']:.4e}"
            + (f" ({ratio:.3f}x JAX's XLA count {jax_flops:.4g})" if tag == "train"
               else "")
            + f"; {res['achieved_tflops']:.2f} TFLOP/s, MFU {res['mfu']:.2%} of "
              f"{res['peak_tflops']:g} TFLOP/s; peak memory {res['peak_memory_gib']:.2f} GiB; "
              f"launches {launches}; wall {wall_s:.1f} s  [{card}]")
        out[tag] = dict(line=line, launches=launches, launches_expected=want, wall_s=wall_s,
                        **{k: v for k, v in res.items() if k != "line"})
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 13. the ViT backbone
# ---------------------------------------------------------------------------

VIT_RUN_STEPS = 2  # phase 13 (c)


def model_errors(got, want) -> list:
    """Per output: max-abs over max(1, max |want|)."""
    return [(g.float() - w.float()).abs().max().item() / max(1.0, w.float().abs().max().item())
            for g, w in zip(got, want)]


def vit_serving(torch, np, cfg, states, args, card, attention, bias_act_mod) -> dict:
    """Phase 13 (a): the ViT Generator's serving forward at T=256, fp32 and
    bf16: kernels vs plain attention, bf16 vs fp32, card vs CPU; then
    ``generate_layouts`` batches with the counts from 0 (12 launches a
    forward), and each forward's time."""
    from layoutdetr_tpu_torch.generate import generate_layouts
    from layoutdetr_tpu_torch.models.generator import Generator

    def build(dtype, flash=True, device="cuda"):
        with torch.device(device):
            m = Generator(cfg, dtype=dtype, flash_attention=flash)
        m.load_state_dict(states[0] if device == "cuda" else
                          {k: v.cpu() for k, v in states[0].items()}, strict=True)
        return m.eval()

    batch = to_device(torch, model_batch(np, cfg, args.batch, args.seed), "cuda")
    out = {}
    with torch.inference_mode():
        want32 = build(torch.float32, flash=False)(**batch)
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            got = build(dtype)(**batch)
            torch.cuda.synchronize()
            want = want32 if dtype == torch.float32 else build(dtype, flash=False)(**batch)
            err = (got - want).abs().max().item()
            err32 = (got - want32).abs().max().item()
            bar = MODEL_TOL if dtype == torch.float32 else MODEL_TOL_BF16
            if (got.shape != (args.batch, 9, 4) or got.dtype != torch.float32
                    or not torch.isfinite(got).all() or not err <= bar
                    or not err32 <= BF16_VS_FP32_TOL):
                raise AssertionError(f"ViT Generator {dtype_name}: {tuple(got.shape)}, kernel vs "
                                     f"plain {err}, vs fp32 plain {err32}")
            out[dtype_name] = dict(kernel_vs_plain=err, vs_fp32_plain=err32)
            log(f"ViT Generator {dtype_name} B={args.batch} T=256: bbox_fake max-abs {err:.3e} "
                f"kernel vs plain attention (bar {bar:.0e}), {err32:.3e} vs the fp32 plain model")
        small = model_batch(np, cfg, 1, args.seed + 1, t=64)
        got = build(torch.float32)(**to_device(torch, small, "cuda")).cpu()
        want = build(torch.float32, device="cpu")(**to_device(torch, small, "cpu"))
    err_cpu = (got - want).abs().max().item()
    if not err_cpu <= CPU_TOL:
        raise AssertionError(f"ViT Generator card vs CPU: max-abs {err_cpu}")
    out["card_vs_cpu"] = err_cpu
    log(f"ViT Generator fp32 B=1 T=64, card vs CPU: bbox_fake max-abs {err_cpu:.3e}")
    del batch, want32, got, want

    reqs = requests(np, cfg, args.batch, args.seed)
    models = {d: build(getattr(torch, d)) for d in ("float32", "bfloat16")}
    zero_counters(attention, bias_act_mod)
    forwards = 0
    for dtype_name, m in models.items():
        e2e = []
        for i in range(4):  # the first batch warms up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            layouts = generate_layouts(m, reqs, seed=args.seed + i, device="cuda")
            torch.cuda.synchronize()
            e2e.append(time.perf_counter() - t0)
            forwards += 1
            for lay in layouts:
                if not np.isfinite(lay.bbox).all() or not ((lay.raw > 0) & (lay.raw < 1)).all():
                    raise AssertionError(f"ViT served layout out of range: {lay.raw}")
        e2e_s = sum(e2e[1:]) / len(e2e[1:])
        out[dtype_name].update(requests_per_s=args.batch / e2e_s, request_batch_ms=1e3 * e2e_s)
    launches = counters(attention, bias_act_mod)
    want = dict(fused_attention=12 * forwards, fused_attention_dropout=0, bias_act=0,
                bias_act_backward=0)
    if launches != want:
        raise AssertionError(f"ViT serving: launches {launches} in {forwards} forwards, "
                             f"expected {want}")
    out["launches"] = launches
    inputs = to_device(torch, model_batch(np, cfg, args.batch, args.seed), "cuda")
    for dtype_name, m in models.items():
        with torch.inference_mode():
            fwd_ms = cuda_ms(torch, lambda: m(**inputs), 5, warmup=1)
        r = out[dtype_name]
        r.update(forward_ms=fwd_ms, images_per_s=args.batch / fwd_ms * 1e3)
        log(f"ViT serving {dtype_name} T=256 batch {args.batch}: {r['requests_per_s']:.1f} "
            f"requests/s end to end ({r['request_batch_ms']:.1f} ms a batch), forward "
            f"{fwd_ms:.1f} ms = {r['images_per_s']:.1f} images/s  [{card}]")
    log(f"main path (ViT serving): {forwards} served batches, launches {launches}")
    return out


def vit_training_run(torch, args, card, attention, bias_act_mod, tmp: str, zip_path: str,
                     val_path: str, t: int) -> dict:
    """Phase 13 (c): ``train.main --backbone vit`` at full width for
    VIT_RUN_STEPS steps on phase 9's zip (bf16, T=``t`` auto, R1 and path
    length at step 0, a snapshot), then ``evaluate.main`` on that snapshot
    (layout FID on the val.zip), with the counts from 0 before the run and
    read after the evaluation."""
    from layoutdetr_tpu_torch import evaluate
    from layoutdetr_tpu_torch import train as train_cli
    from layoutdetr_tpu_torch.metrics import layout_fid

    out = os.path.join(tmp, "vit_runs")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters(attention, bias_act_mod)
    t0 = time.perf_counter()
    state = train_cli.main(["--outdir", out, "--data", zip_path, "--batch", str(args.batch),
                            "--bf16", "--backbone", "vit", "--max-text-length", "auto", "--gamma",
                            "1", "--pl-weight", "2", "--seed", str(args.seed), "--snap", "1",
                            "--metrics", "none", "--device-feed", "on", "--gpus", "1",
                            "--max-steps", str(VIT_RUN_STEPS)])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    (run_name,) = os.listdir(out)
    run_dir = os.path.join(out, run_name)
    records, ticks = read_run(run_dir)
    check_ticks(records, ticks, VIT_RUN_STEPS, "ViT training run")
    snaps = sorted(n for n in os.listdir(run_dir) if n.endswith(".pt"))
    if state.step != VIT_RUN_STEPS or not snaps:
        raise AssertionError(f"ViT training run: step {state.step}, snapshots {snaps}")
    snap = os.path.join(run_dir, snaps[-1])
    with open(snap + ".gcfg.json") as f:
        gcfg = json.load(f)
    if gcfg["backbone"] != "vit" or gcfg["max_text_length"] != t:
        raise AssertionError(f"ViT snapshot config: {gcfg}")
    del state
    torch.cuda.empty_cache()

    eval_dir = os.path.join(tmp, "eval_vit")
    os.makedirs(eval_dir)
    t0 = time.perf_counter()
    with counted_generation(layout_fid, {}) as gen, contextlib.chdir(tmp):
        results = evaluate.main(["--ckpt", snap, "--data", val_path, "--metrics",
                                 "layout_fid50k_val", "--batch", str(args.batch), "--max-items",
                                 str(EVAL_ITEMS), "--run-dir", eval_dir, "--seed", str(args.seed),
                                 "--device", "cuda"])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = counters(attention, bias_act_mod)
    fid = results[0]["results"]["layout_fid50k_val"]
    g_regs = len(range(0, VIT_RUN_STEPS, G_REG))
    d_regs = len(range(0, VIT_RUN_STEPS, D_REG))
    forwards = math.ceil(EVAL_ITEMS / args.batch)
    # as phase 9's: reg steps, the two module summaries, an image snapshot
    # a tick, then the evaluation's G_ema forwards
    want = dict(fused_attention=12 * (g_regs + d_regs) + 12 * 2 + 12 * len(ticks) + 12 * forwards,
                fused_attention_dropout=12 * VIT_RUN_STEPS, bias_act=48 * VIT_RUN_STEPS + 48,
                bias_act_backward=48 * VIT_RUN_STEPS)
    if launches != want or gen.get("forwards") != forwards or not math.isfinite(fid):
        raise AssertionError(f"ViT training run and evaluation: launches {launches} (expected "
                             f"{want}), {gen.get('forwards')} G_ema forwards, FID {fid}")
    rec = dict(steps=VIT_RUN_STEPS, ticks=len(ticks), train_wall_s=train_s,
               sec_per_kimg=records[-1]["sec_per_kimg"], peak_memory_gb=peak_gb,
               snapshot=os.path.basename(snap), T=t, layout_fid=fid, eval_wall_s=eval_s,
               eval_total_time_s=results[0]["total_time"], launches=launches)
    log(f"ViT training run (train.main --backbone vit, bf16, batch {args.batch}, T={t}, "
        f"{VIT_RUN_STEPS} steps + {g_regs} path-length + {d_regs} R1): wall {train_s:.1f} s, "
        f"peak memory {peak_gb:.2f} GiB; evaluate.main on {os.path.basename(snap)}: "
        f"layout_fid50k_val {fid:.4f} on {EVAL_ITEMS} items ({eval_s:.1f} s); launches "
        f"{launches} (as expected)  [{card}]")
    return rec


def vit_phase(torch, np, args, card, attention, bias_act_mod, tmp: str, zip_path: str,
              val_path: str, t: int) -> dict:
    """Phase 13, the ViT family at full width (``GeneratorConfig(backbone=
    "vit")``, weights from --seed): (a) serving, (b) the bf16 T=256 train
    step (counted, timed, profiled) and one deterministic fp32 step kernels
    vs plain and card vs CPU, (c) the training CLI and the evaluation."""
    from layoutdetr_tpu_torch.config import GeneratorConfig
    from layoutdetr_tpu_torch.models.discriminator import Discriminator
    from layoutdetr_tpu_torch.models.generator import Generator

    cfg = GeneratorConfig(backbone="vit")
    torch.manual_seed(args.seed)
    with torch.device("cuda"):
        states = (Generator(cfg).state_dict(), Discriminator(cfg).state_dict())
    rec = dict(serving=vit_serving(torch, np, cfg, states, args, card, attention, bias_act_mod))
    torch.cuda.empty_cache()
    rec["train"] = train_phase(torch, np, cfg, states, args, card, attention, bias_act_mod,
                               variants=(("bfloat16", 256),))
    rec["step_correctness"] = step_correctness_phase(torch, np, cfg, states, args, attention,
                                                     bias_act_mod)
    del states
    torch.cuda.empty_cache()
    rec["training_run"] = vit_training_run(torch, args, card, attention, bias_act_mod, tmp,
                                           zip_path, val_path, t)
    return rec


# ---------------------------------------------------------------------------
# 14. LayoutGAN++
# ---------------------------------------------------------------------------

LGPP_PARTIAL = 7  # phase 14's partial batch


def lgpp_batch(np, cfg, b: int, seed: int) -> dict:
    """LayoutGAN++ inputs: ``model_batch``'s, with D's boxes and the
    character lengths the variant reads as len / 40."""
    m = model_batch(np, cfg, b, seed)
    m["bbox"] = m["bbox_real"]
    return m


def encoder_calls(torch, cfg, batch: int) -> list:
    """The arguments of every bias_act call of one ``bg_encoder`` forward of a
    full-width LayoutGAN++ D (seeded random weights)."""
    from layoutdetr_tpu_torch.models.layoutganpp import LayoutGanPPDiscriminator
    from layoutdetr_tpu_torch.ops import bias_act as bias_act_mod

    with torch.device("cuda"):
        disc = LayoutGanPPDiscriminator(cfg)
    calls = []
    bg = torch.randn(batch, 3, cfg.background_size, cfg.background_size, device="cuda")
    with recorded_bias_act_calls(bias_act_mod, calls), torch.no_grad():
        disc.bg_encoder(bg)
    want = 4 + 3 * (len(disc.bg_encoder.block_resolutions) - 1) + 3
    if len(calls) != want:
        raise AssertionError(f"{len(calls)} bias_act calls in one bg_encoder forward, expected "
                             f"{want}")
    del disc
    return calls


def _with_plain_attention(torch, module):
    for m in module.modules():
        if hasattr(m, "flash_attention"):
            m.flash_attention = False
    return module


def lgpp_d_backward(torch, D, inputs, cots) -> tuple:
    """D(reconst=True) forward with gradients, then the gradient of the fixed
    scalar sum(out_i * cot_i) with respect to every parameter."""
    outs = D(**inputs, reconst=True)
    scalar = sum((o.float() * c).sum() for o, c in zip(outs, cots))
    grads = torch.autograd.grad(scalar, list(D.parameters()), allow_unused=True)
    return outs, grads


@contextlib.contextmanager
def recorded_lrelu_inputs(torch, bias_act_mod, seen: list):
    """Inside, the input of every lrelu bias_act forward (x + b, fp32, on
    the CPU) is appended to ``seen``."""
    real = bias_act_mod.bias_act_forward

    def record(x, b, dim, act, alpha, gain, clamp):
        if act == "lrelu":
            view = [-1 if i == dim else 1 for i in range(x.dim())]
            seen.append((x.detach().float() + b.detach().float().view(view)).cpu())
        return real(x, b, dim, act, alpha, gain, clamp)

    bias_act_mod.bias_act_forward = record
    try:
        yield
    finally:
        bias_act_mod.bias_act_forward = real


def kink_flips(got: list, want: list) -> dict:
    """Elements whose lrelu input lies on the other side of 0 in ``got``
    than in ``want`` (recorded by ``recorded_lrelu_inputs``), and the
    largest |input| among them."""
    flips, largest = 0, 0.0
    for a, b in zip(got, want):
        differ = (a > 0) != (b > 0)
        n = int(differ.sum())
        if n:
            flips += n
            largest = max(largest, float(b[differ].abs().max()), float(a[differ].abs().max()))
    return dict(flips=flips, largest_abs_input=largest, calls=len(want))


def grad_rel_l2(torch, got, want) -> float:
    """||got - want|| / ||want|| over every parameter's gradient as one vector
    (a None gradient is 0): one element near an lrelu kink can move a
    single bias's gradient, not the vector."""
    num = den = 0.0
    for g, w in zip(got, want):
        if w is None:
            continue
        g = torch.zeros_like(w) if g is None else g
        num += (g.double() - w.double().to(g.device)).square().sum().item()
        den += w.double().square().sum().item()
    return math.sqrt(num / den)


LGPP_NAMES = ("bbox_fake", "logit", "bbox_pred", "loss_lm", "bg_rec")


def layoutganpp_phase(torch, np, args, card, attention, bias_act_mod, enc_calls: int) -> dict:
    """Phase 14, the LayoutGAN++ pair at full width (``LayoutGanPPConfig()``:
    BERT 768 x 12, f_dim 256, 8 layers of 512, StyleGAN2 encoder and
    decoder at 256^2, T=40), batch 16, fp32 and bf16: with the counts from
    0, G forwards at batch 16 and at a partial batch, D(reconst=True)
    forwards, and D(reconst=True) forward + backward of a fixed scalar of its
    outputs, counts read after (``enc_calls`` bias_act calls an encoder
    forward, 48 a decoder forward); then each against the same with plain
    attention and plain bias_act, the card against the CPU (fp32, batch 2),
    and their times."""
    from layoutdetr_tpu_torch.models.layoutganpp import (
        LayoutGanPPConfig,
        LayoutGanPPDiscriminator,
        LayoutGanPPGenerator,
    )

    cfg = LayoutGanPPConfig()
    torch.manual_seed(args.seed)
    with torch.device("cuda"):
        states = (LayoutGanPPGenerator(cfg).state_dict(),
                  LayoutGanPPDiscriminator(cfg).state_dict())

    def build(dtype, device="cuda", plain=False):
        out = []
        for cls, sd in zip((LayoutGanPPGenerator, LayoutGanPPDiscriminator), states):
            with torch.device(device):
                m = cls(cfg, dtype=dtype)
            m.load_state_dict(sd if device == "cuda" else {k: v.cpu() for k, v in sd.items()},
                              strict=True)
            out.append(_with_plain_attention(torch, m.eval()) if plain else m.eval())
        return out

    def g_inputs(m):
        return {k: m[k] for k in ("z", "bbox_class", "bbox_real", "text_ids", "text_mask",
                                  "text_len", "padding_mask", "background")}

    def d_inputs(m):
        return {k: m[k] for k in ("bbox", "bbox_class", "text_ids", "text_mask", "text_len",
                                  "padding_mask", "background")}

    full = to_device(torch, lgpp_batch(np, cfg, args.batch, args.seed), "cuda")
    part = to_device(torch, lgpp_batch(np, cfg, LGPP_PARTIAL, args.seed + 1), "cuda")
    rng = np.random.default_rng(args.seed + 14)
    shapes = [(args.batch, 9), (args.batch,), (args.batch, 9, 4), (),
              (args.batch, cfg.background_size, cfg.background_size, 3)]
    cots = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).cuda() for s in shapes[1:]]
    models = {d: build(getattr(torch, d)) for d in ("float32", "bfloat16")}
    dec_calls = 48

    # the main path, counted
    zero_counters(attention, bias_act_mod)
    seen = {}
    for dtype_name, (G, D) in models.items():
        with torch.inference_mode():
            seen[dtype_name] = dict(g=G(**g_inputs(full)), g_part=G(**g_inputs(part)),
                                    d=D(**d_inputs(full), reconst=True))
        seen[dtype_name]["d_grad"] = lgpp_d_backward(torch, D, d_inputs(full), cots)
    torch.cuda.synchronize()
    launches = counters(attention, bias_act_mod)
    # a no-grad forward runs the frozen text pass through the kernel (12);
    # with gradients the text encoder runs plain attention
    want = dict(fused_attention=2 * 12 * 3, fused_attention_dropout=0,
                bias_act=2 * (2 * enc_calls + 2 * (enc_calls + dec_calls)),
                bias_act_backward=2 * (enc_calls + dec_calls))
    if launches != want:
        raise AssertionError(f"LayoutGAN++: launches {launches}, expected {want}")
    for dtype_name, r in seen.items():
        outs = [r["g"], r["g_part"], *r["d"], *r["d_grad"][0]]
        bad = [i for i, o in enumerate(outs) if not torch.isfinite(o.float()).all()]
        bad += ["grads"] * any(g is not None and not torch.isfinite(g.float()).all()
                               for g in r["d_grad"][1])
        if bad or r["g"].shape != (args.batch, 9, 4) or r["d"][3].shape != full["background"].shape:
            raise AssertionError(f"LayoutGAN++ {dtype_name}: non-finite {bad}, shapes "
                                 f"{tuple(r['g'].shape)} {tuple(r['d'][3].shape)}")

    rec = dict(launches=launches, calls_per_encoder=enc_calls)
    for dtype_name, r in seen.items():
        dtype = getattr(torch, dtype_name)
        G, D = build(dtype, plain=True)
        with plain_bias_act(bias_act_mod):
            n0 = counters(attention, bias_act_mod)
            with torch.inference_mode():
                want_out = [G(**g_inputs(full)), G(**g_inputs(part)),
                            *D(**d_inputs(full), reconst=True)]
            d_outs, d_grads = lgpp_d_backward(torch, D, d_inputs(full), cots)
            if counters(attention, bias_act_mod) != n0:
                raise AssertionError("the plain LayoutGAN++ forwards launched a kernel")
        errs = model_errors([r["g"], r["g_part"], *r["d"]], want_out)
        bg_err = (r["d"][3].float() - want_out[5].float()).abs().max().item() / \
            want_out[5].float().abs().max().item()
        grad_err = grad_rel_l2(torch, r["d_grad"][1], d_grads)
        bar = MODEL_TOL if dtype == torch.float32 else MODEL_TOL_BF16
        # bf16: the two runs' text features differ by a bf16 rounding, and the
        # decoder carries that to bg_rec; each run lies within
        # BF16_VS_FP32_TOL of the fp32 function, so within twice that of the
        # other
        bg_bar = MODEL_TOL if dtype == torch.float32 else 2 * BF16_VS_FP32_TOL
        if not (max(errs[:5]) <= bar and bg_err <= bg_bar
                and (dtype != torch.float32 or grad_err <= MODEL_TOL)):
            raise AssertionError(f"LayoutGAN++ {dtype_name} kernels vs plain: outputs {errs}, "
                                 f"bg_rec {bg_err}, D gradient {grad_err}")
        rec[dtype_name] = dict(kernels_vs_plain=dict(zip(("bbox_fake", "bbox_fake_partial",
                                                          *LGPP_NAMES[1:4]), errs[:5]),
                                                     bg_rec_rel=bg_err, d_grad_rel_l2=grad_err))
        log(f"LayoutGAN++ {dtype_name} B={args.batch} T=40, kernels vs plain versions: outputs "
            f"max-abs (relative above 1) {', '.join(f'{e:.2e}' for e in errs[:5])}, bg_rec "
            f"{bg_err:.2e} of max, D's gradient relative L2 {grad_err:.2e}")
        del G, D, want_out, d_outs, d_grads

    # card vs CPU, fp32, batch 2
    small = lgpp_batch(np, cfg, 2, args.seed + 2)
    got_g, got_d = models["float32"]
    cpu_g, cpu_d = build(torch.float32, device="cpu")
    small_cots = [(c[:2] if c.dim() else c).cpu() for c in cots]
    res, lrelu_in = {}, {}
    for dev, (G, D) in (("cuda", (got_g, got_d)), ("cpu", (cpu_g, cpu_d))):
        inputs = to_device(torch, small, dev)
        with torch.inference_mode():
            g = G(**g_inputs(inputs))
        with recorded_lrelu_inputs(torch, bias_act_mod, lrelu_in.setdefault(dev, [])):
            d_out, d_grad = lgpp_d_backward(torch, D, d_inputs(inputs),
                                            [c.to(dev) for c in small_cots])
        res[dev] = ([g.cpu(), *(o.detach().cpu() for o in d_out)],
                    [None if x is None else x.cpu() for x in d_grad])
    errs = model_errors(res["cuda"][0], res["cpu"][0])
    bg_err = (res["cuda"][0][4] - res["cpu"][0][4]).abs().max().item() / \
        res["cpu"][0][4].abs().max().item()
    grad_err = grad_rel_l2(torch, res["cuda"][1], res["cpu"][1])
    kinks = kink_flips(lrelu_in["cuda"], lrelu_in["cpu"])
    del lrelu_in
    names = [n for n, _ in cpu_d.named_parameters()]
    # each leaf's share of the difference: ||g - w|| over the whole ||w||
    whole = math.sqrt(sum(b.double().square().sum().item() for b in res["cpu"][1]
                          if b is not None))
    leaf_err = sorted((((a.double() - b.double()).norm().item() / whole, n) for n, a, b in
                       zip(names, res["cuda"][1], res["cpu"][1]) if b is not None), reverse=True)
    grad_bar = CPU_TOL if kinks["flips"] == 0 else KINK_GRAD_TOL
    if not (max(errs[:4]) <= CPU_TOL and bg_err <= CPU_TOL and grad_err <= grad_bar):
        raise AssertionError(f"LayoutGAN++ card vs CPU: outputs {errs}, bg_rec {bg_err}, D "
                             f"gradient {grad_err} (bar {grad_bar}; lrelu inputs on the other "
                             f"side of 0: {kinks}; worst leaves {leaf_err[:3]})")
    rec["card_vs_cpu"] = dict(outputs=dict(zip(LGPP_NAMES[:4], errs[:4])), bg_rec_rel=bg_err,
                              d_grad_rel_l2=grad_err, d_grad_bar=grad_bar, lrelu_kink_flips=kinks,
                              worst_leaves=leaf_err[:5])
    log(f"LayoutGAN++ fp32 B=2, card vs CPU: outputs {', '.join(f'{e:.2e}' for e in errs[:4])}, "
        f"bg_rec {bg_err:.2e} of max, D's gradient relative L2 {grad_err:.2e} (bar "
        f"{grad_bar:.0e}: {kinks['flips']} of the D's lrelu inputs on the other side of 0, the "
        f"largest |input| among them {kinks['largest_abs_input']:.2e}); the leaves with most of "
        f"the difference (||g - w|| over the whole ||w||) "
        + ", ".join(f"{n} {e:.2e}" for e, n in leaf_err[:3]))
    del cpu_g, cpu_d, res

    # times, outside the counted run
    for dtype_name, (G, D) in models.items():
        with torch.inference_mode():
            g_ms = cuda_ms(torch, lambda: G(**g_inputs(full)), 5, warmup=1)
            d_ms = cuda_ms(torch, lambda: D(**d_inputs(full), reconst=True), 5, warmup=1)
        db_ms = cuda_ms(torch, lambda: lgpp_d_backward(torch, D, d_inputs(full), cots), 3,
                        warmup=1)
        rec[dtype_name].update(g_forward_ms=g_ms, d_forward_ms=d_ms, d_forward_backward_ms=db_ms,
                               g_images_per_s=args.batch / g_ms * 1e3)
        log(f"LayoutGAN++ {dtype_name} batch {args.batch}: G forward {g_ms:.2f} ms "
            f"({rec[dtype_name]['g_images_per_s']:.1f} images/s), D(reconst) forward {d_ms:.2f} "
            f"ms, D forward + backward {db_ms:.2f} ms  [{card}]")
    log(f"main path (LayoutGAN++): launches {launches} (as expected; {enc_calls} bias_act calls "
        f"an encoder forward, {dec_calls} a decoder forward)")
    del models, seen
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# 15. multi-GPU training
# ---------------------------------------------------------------------------

MG_RANKS = 2
MG_RUN_STEPS, MG_RESUME_STEPS = 6, 2  # (c): path length at 0 and 4, R1 at 0, ADA at 4


def loop_launches(steps: int, g_regs: int, d_regs: int, previews: int) -> dict:
    """A rank's launches in ``training_loop``: 12 attention with dropout a
    main step; 12 deterministic a reg step, a summary forward (G, D) and a
    preview (rank 0's, one a tick); 48 + 48 bias_act a main step and 48
    forward in D's summary."""
    return dict(fused_attention=12 * (g_regs + d_regs + 2 + previews),
                fused_attention_dropout=12 * steps, bias_act=48 * steps + 48,
                bias_act_backward=48 * steps)


def multi_gpu_rank(spec_path: str, out: str) -> None:
    """One rank of phase 15, inside its grid (``parallel.distributed.spawn``:
    gloo, both ranks on one card). Writes ``<out>/rank<r>.json``."""
    import numpy as np
    import torch

    from layoutdetr_tpu_torch.ops import attention
    from layoutdetr_tpu_torch.ops import bias_act as bias_act_mod
    from layoutdetr_tpu_torch.parallel import distributed
    from layoutdetr_tpu_torch.parallel import tensor_parallel as tp
    from layoutdetr_tpu_torch.training import train_loop
    from layoutdetr_tpu_torch.training.loss import LossWeights
    from layoutdetr_tpu_torch.utils.misc import check_replica_consistency

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = torch.load(spec_path, weights_only=False)
    g = distributed.grid()
    dev, cfg, batch_size, seed = g.device, spec["cfg"], spec["batch"], spec["seed"]
    vcfg = dataclasses.replace(cfg, max_text_length=256, text_len_table=256)
    states = torch.load(spec["states"], map_location=dev, weights_only=True)
    rec = dict(rank=g.rank)

    def check_launches(launches, want, what):
        """On the card each kernel launched as often as expected; on a CPU
        rehearsal the plain versions ran and no count moved."""
        if dev.type != "cuda":
            want = dict.fromkeys(want, 0)
        if launches != want:
            raise AssertionError(f"{what} rank {g.rank}: launches {launches}, expected {want}")

    def local(x):  # this data rank's rows of the global batch
        share = batch_size // g.dp_size
        return x[g.dp_rank * share:(g.dp_rank + 1) * share]

    def sharded_state(dtype):
        state = new_train_state(torch, vcfg, dtype, states, dev)
        for m in (state.G, state.D, state.G_ema):
            distributed.broadcast_module_(m)
            tp.shard_module_(m, g.tp_rank, g.tp_size)
        return state

    def compare_step(what):
        """Phase 8's deterministic fp32 step over the grid, held to the
        one-process step (rank 0 compares; every rank checks its replicas)."""
        state = sharded_state(torch.float32)
        batch = {k: local(v) for k, v in train_batch(torch, np, vcfg, batch_size, seed, dev).items()}
        zg = np.random.default_rng(seed + 11).normal(size=(2, batch_size, 9, vcfg.z_dim))
        z = tuple(local(torch.from_numpy(x.astype(np.float32)).to(dev)) for x in zg)
        zero_counters(attention, bias_act_mod)
        stats = make_step(vcfg, batch_size, deterministic=True)(state, batch, torch.Generator(), z=z)
        stats = {k: float(v) for k, v in stats.items()}
        launches = counters(attention, bias_act_mod)
        check_launches(launches, dict(fused_attention=12, fused_attention_dropout=0, bias_act=48,
                                      bias_act_backward=48), what)
        check_replica_consistency({"G": state.G, "D": state.D, "G_ema": state.G_ema})
        full = {m: tp.gather_state_dict(getattr(state, m).state_dict(), g.tp_rank, g.tp_size,
                                        g.tp_group) for m in ("G", "D")}
        summed = distributed.all_reduce_host([stats[k] for k in sorted(stats)])
        out = dict(launches=launches)
        if g.is_chief:  # the ranks' mean stats and the full parameters
            got = dict(stats={k: v / g.world for k, v in zip(sorted(stats), summed)},
                       **{m: {k: v.detach().cpu() for k, v in sd.items()} for m, sd in full.items()})
            out.update(compare_steps(torch, got, torch.load(spec["reference"], weights_only=True),
                                     what))
            del got
        del state, full
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return out

    # (a) data parallel 2 x 1
    rec["dp_fp32"] = compare_step("DP 2x1 vs one process")
    state = sharded_state(torch.bfloat16)
    batch = {k: local(v) for k, v in train_batch(torch, np, vcfg, batch_size, seed, dev).items()}
    step = make_step(vcfg, batch_size, deterministic=False)
    gen = torch.Generator().manual_seed(distributed.rank_seed(seed, g.dp_rank))
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    zero_counters(attention, bias_act_mod)
    times, seen = [], []
    for i in range(3):  # the first warms up
        t0 = time.perf_counter()
        seen.append(step(state, batch, gen))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = counters(attention, bias_act_mod)
    check_launches(launches, dict(fused_attention=0, fused_attention_dropout=36, bias_act=144,
                                  bias_act_backward=144), "DP bf16")
    bad = [k for s in seen for k, v in s.items() if not math.isfinite(float(v))]
    if bad:
        raise AssertionError(f"DP bf16 rank {g.rank}: non-finite {bad}")
    rec["dp_bf16"] = dict(step_ms=times[1:], launches=launches,
                          peak_memory_gb=(torch.cuda.max_memory_allocated() / 1e9
                                          if dev.type == "cuda" else None))
    del state, batch, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # (b) tensor parallel 1 x 2 over the same ranks
    distributed.make_grid(MG_RANKS)
    g = distributed.grid()
    rec["tp_fp32"] = compare_step("TP 1x2 vs one process")

    # (c) training_loop, data parallel, then a resume
    distributed.make_grid(1)
    g = distributed.grid()
    kw = dict(data=spec["zip"], gcfg=spec["run_gcfg"], batch_size=batch_size, dtype=torch.bfloat16,
              loss_weights=LossWeights(pl_weight=2.0, r1_gamma=1.0), g_reg_interval=G_REG,
              d_reg_interval=D_REG, aug="ada", kimg_per_tick=1, network_snapshot_ticks=1,
              image_snapshot_ticks=1, random_seed=seed, device=dev)
    runs = {}
    for name, steps, extra in (("run", MG_RUN_STEPS, dict(device_feed="on")),
                               ("resume", MG_RESUME_STEPS,
                                dict(device_feed="off", num_workers=0,
                                     resume=os.path.join(spec["run_dir"],
                                                         "network-snapshot-000000.pt")))):
        run_dir = spec["run_dir"] if name == "run" else spec["resume_dir"]
        zero_counters(attention, bias_act_mod)
        seen = []
        real = train_loop.AdaController.update

        def update(self, *a, real=real, seen=seen):
            seen.append(real(self, *a))
            return seen[-1]

        train_loop.AdaController.update = update
        t0 = time.perf_counter()
        try:
            state = train_loop.training_loop(run_dir=run_dir, max_steps=steps, **kw, **extra)
        finally:
            train_loop.AdaController.update = real
        wall_s = time.perf_counter() - t0
        launches = counters(attention, bias_act_mod)
        check_launches(launches, loop_launches(steps, len(range(0, steps, G_REG)),
                                               len(range(0, steps, D_REG)), 2 if g.is_chief else 0),
                       f"training_loop {name}")
        runs[name] = dict(step=state.step, ada_p=seen, pl_mean=float(state.pl_mean),
                          launches=launches, wall_s=wall_s)
        del state
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    rec["loop"] = runs
    with open(os.path.join(out, f"rank{g.rank}.json"), "w") as f:
        json.dump(rec, f)


def multi_gpu_phase(torch, np, args, card, attention, bias_act_mod, tmp: str, zip_path: str,
                    t: int, states_path: str, device: str = "cuda", cfg=None) -> dict:
    """Phase 15, multi-GPU training on the one card: (a) data parallel 2 x 1
    and (b) tensor parallel 1 x 2, two ranks over gloo on ``device``, each
    a deterministic fp32 step at the global batch held to the one-process
    step at phase 8's bars, (a) also 3 bf16 steps with dropout (per-rank
    step ms, peak memory, 12 + 48 + 48 launches a step); (c)
    ``training_loop`` over the 2 ranks on phase 9's zip (bf16, ADA, both
    reg steps, a snapshot each tick with the replica check), a resume from
    its snapshot and ``generate`` from it; (d) one step through an NCCL
    group of one rank, equal to the no-group step bit for bit. Two ranks
    sharing one card say nothing of scaling."""
    import zipfile

    from layoutdetr_tpu_torch import generate
    from layoutdetr_tpu_torch.config import GeneratorConfig
    from layoutdetr_tpu_torch.data.dataset import LayoutDataset
    from layoutdetr_tpu_torch.parallel import distributed

    cfg = cfg or GeneratorConfig()
    on_card = device == "cuda"
    states = torch.load(states_path, weights_only=True)
    ref = one_step(torch, np, cfg, states, args.batch, 256, args.seed, device)
    ref_path = os.path.join(tmp, "reference.pt")
    torch.save(ref, ref_path)
    if on_card:
        torch.cuda.empty_cache()
    # the config train.main gives phase 9's zip at --max-text-length auto
    gcfg = dataclasses.replace(
        cfg, num_bbox_labels=LayoutDataset(zip_path, cache=False).num_bbox_labels,
        max_text_length=t, text_len_table=256)
    run_dir, resume_dir = os.path.join(tmp, "mg_run"), os.path.join(tmp, "mg_resumed")
    for d in (run_dir, resume_dir):
        os.makedirs(d)
    spec = os.path.join(tmp, "mg_spec.pt")
    torch.save(dict(cfg=cfg, batch=args.batch, seed=args.seed, states=states_path,
                    reference=ref_path, zip=zip_path, run_gcfg=gcfg, run_dir=run_dir,
                    resume_dir=resume_dir), spec)
    t0 = time.perf_counter()
    distributed.spawn(multi_gpu_rank, MG_RANKS, (spec, tmp),
                      devices=["cuda:0" if on_card else device] * MG_RANKS, backend="gloo",
                      timeout_s=900)
    wall_s = time.perf_counter() - t0
    ranks = []
    for r in range(MG_RANKS):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            ranks.append(json.load(f))

    # (c) one step, one pl_mean and one ADA p (moved at batch 4 of the run)
    # on every rank; rank 0's files
    for name, steps in (("run", MG_RUN_STEPS), ("resume", MG_RUN_STEPS + MG_RESUME_STEPS)):
        got = [(r["loop"][name]["step"], r["loop"][name]["ada_p"], r["loop"][name]["pl_mean"])
               for r in ranks]
        if any(x != got[0] for x in got) or got[0][0] != steps or (name == "run" and not got[0][1]):
            raise AssertionError(f"training_loop {name}: (step, ADA p, pl_mean) by rank {got}")
    for d, steps in ((run_dir, MG_RUN_STEPS), (resume_dir, MG_RESUME_STEPS)):
        # rank 0's stats.jsonl alone: tick 0 and the last; the collector
        # sums both ranks, two reports a main step; every value finite
        records = read_jsonl(os.path.join(d, "stats.jsonl"))
        nums = [sum(r[k]["num"] for r in records) for k in ("Loss/G/loss_Ggen", "Loss/D/loss_Dreal")]
        bad = [k for r in records for k, v in r.items() if isinstance(v, dict) and v["num"]
               and not (math.isfinite(v["mean"]) and math.isfinite(v["std"]))]
        snaps = sorted(n for n in os.listdir(d) if n.startswith("network-snapshot"))
        if (len(records) != 2 or nums != [MG_RANKS * steps] * 2 or bad
                or snaps != ["network-snapshot-000000.pt", "network-snapshot-000000.pt.gcfg.json"]):
            raise AssertionError(f"multi-GPU training_loop in {d}: {len(records)} stats lines, "
                                 f"main-step reports {nums}, non-finite {bad}, snapshots {snaps}")
    snap = os.path.join(run_dir, "network-snapshot-000000.pt")
    bg = os.path.join(tmp, "mg_bg.png")
    with zipfile.ZipFile(zip_path) as zf, open(bg, "wb") as f:
        f.write(zf.read("00000000_background_orig.png"))
    zero_counters(attention, bias_act_mod)
    (layout,) = generate.main(["--ckpt", snap, "--bg", bg, "--strings", "summer sale|shop now",
                               "--string-labels", "header|button", "--device", device,
                               "--outfile", os.path.join(tmp, "mg_served", "banner")])
    served = counters(attention, bias_act_mod)
    if not np.isfinite(layout.bbox).all() or not ((layout.raw > 0) & (layout.raw < 1)).all():
        raise AssertionError(f"serving from the multi-GPU snapshot: {layout.raw}")

    # (d) one rank through NCCL against no group, bit for bit
    nccl = None
    if on_card:
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        zero_counters(attention, bias_act_mod)
        try:
            alone = one_step(torch, np, cfg, states, 2, 64, args.seed + 1, device)
            distributed.init(0, 1, 1, "cuda:0",
                             init_method=f"tcp://127.0.0.1:{distributed.free_port()}")
            try:
                grouped = one_step(torch, np, cfg, states, 2, 64, args.seed + 1, device)
            finally:
                distributed.shutdown()
        finally:
            torch.backends.cudnn.deterministic = deterministic
        same_bits(torch, grouped, alone, "NCCL group of one rank vs no group")
        nccl = dict(bit_exact=True, launches=counters(attention, bias_act_mod))
        del alone, grouped
        torch.cuda.empty_cache()

    by_kernel = {}
    for r in ranks:
        parts = [r["dp_fp32"]["launches"], r["dp_bf16"]["launches"], r["tp_fp32"]["launches"],
                 r["loop"]["run"]["launches"], r["loop"]["resume"]["launches"]]
        for launches in parts:
            for k, n in launches.items():
                by_kernel[k] = by_kernel.get(k, 0) + n
    for launches in ([served] + ([nccl["launches"]] if nccl else [])):
        for k, n in launches.items():
            by_kernel[k] += n
    rec = dict(ranks=ranks, wall_s=wall_s, served_launches=served, nccl_one_rank=nccl,
               launches=by_kernel)
    for r in ranks:
        dp, tp_, bf = r.get("dp_fp32", {}), r.get("tp_fp32", {}), r["dp_bf16"]
        log(f"multi-GPU rank {r['rank']} (2 ranks over gloo on one card): bf16 DP step "
            f"{', '.join(f'{x:.1f}' for x in bf['step_ms'])} ms at batch {args.batch // MG_RANKS} a "
            f"rank, peak memory {bf['peak_memory_gb'] or 0:.2f} GB; launches a rank {bf['launches']} "
            f"in 3 steps; training_loop {r['loop']['run']['wall_s']:.1f} s + resume "
            f"{r['loop']['resume']['wall_s']:.1f} s  [{card}]")
    for what in ("dp_fp32", "tp_fp32"):
        c = ranks[0][what]
        log(f"multi-GPU {what} vs one process (fp32, B={args.batch}, T=256): losses max rel "
            f"{c['loss_max_rel']:.3e}; params_g max-abs {c['G']['max_abs']:.3e} "
            f"({c['G']['share_off']:.2e} off), params_d max-abs {c['D']['max_abs']:.3e} "
            f"({c['D']['share_off']:.2e} off)")
    log(f"multi-GPU training_loop: {MG_RUN_STEPS} steps + resume {MG_RESUME_STEPS} on 2 ranks, "
        f"ADA p {ranks[0]['loop']['run']['ada_p']} on both, replica check at every snapshot; "
        f"served from its snapshot; NCCL one rank: {'bit for bit' if nccl else 'not run'}; "
        f"launches {by_kernel}; wall {wall_s:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# 16. the host data path
# ---------------------------------------------------------------------------

HOST_PAGES, HOST_STEPS = 16, 4
REFERENCE_PAGES = 7672  # the reference dataset's pages
HOST_TIMING_PASSES = 3
# banner sizes (w, h): IAB formats and square/social crops, sides <= 1024
BANNER_FORMATS = ((300, 250), (336, 280), (728, 90), (970, 250), (160, 600), (300, 600),
                  (320, 480), (480, 320), (640, 640), (800, 800), (1024, 512), (512, 1024),
                  (1024, 1024), (600, 500), (960, 640))


def banner_source(np, root: str, pages: int, seed: int) -> None:
    """A source tree in the dataset tool's input layout:
    ``png_json_gt/<name>.png`` + ``<name>.json`` and
    ``1x_inpainted_background_png/<name>_inpainted.png``. Page i has size
    BANNER_FORMATS[i % 15] and 1-9 elements, each a box with text in its
    own cell of a 3 x 3 grid; the background is the page without them."""
    import PIL.Image
    import PIL.ImageDraw

    rng = np.random.default_rng(seed)
    gt = os.path.join(root, "png_json_gt")
    bgd = os.path.join(root, "1x_inpainted_background_png")
    os.makedirs(gt)
    os.makedirs(bgd)
    for i in range(pages):
        w, h = BANNER_FORMATS[i % len(BANNER_FORMATS)]
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        bg = np.stack([60 + 150 * xx / w, 40 + 160 * yy / h, 200 - 120 * (xx + yy) / (w + h)], -1)
        bg = (bg + rng.normal(0, 6, bg.shape)).clip(0, 255).astype(np.uint8)
        page = PIL.Image.fromarray(bg)
        draw = PIL.ImageDraw.Draw(page)
        elements = []
        cw, ch = w // 3, h // 3
        for cell in rng.permutation(9)[:int(rng.integers(1, 10))].tolist():
            x1 = (cell % 3) * cw + int(rng.integers(0, cw // 4 + 1))
            y1 = (cell // 3) * ch + int(rng.integers(0, ch // 4 + 1))
            x2 = x1 + max(4, int(cw * rng.uniform(0.5, 0.75)))
            y2 = y1 + max(4, int(ch * rng.uniform(0.5, 0.75)))
            color = tuple(int(v) for v in rng.integers(0, 256, 3))
            draw.rectangle([x1, y1, x2 - 1, y2 - 1], fill=color)
            text = " ".join(rng.choice(WORDS, int(rng.integers(1, 6))))
            draw.text((x1 + 2, y1 + 1), text, fill=tuple(255 - c for c in color))
            elements.append({"label": LABELS[int(rng.integers(0, len(LABELS)))], "str": text,
                             "xyxy_word_fit": [x1, y1, x2, y2]})
        name = f"page{i:06d}"
        page.save(os.path.join(gt, name + ".png"), compress_level=1)
        with open(os.path.join(gt, name + ".json"), "w") as f:
            json.dump(elements, f)
        PIL.Image.fromarray(bg).save(os.path.join(bgd, name + "_inpainted.png"), compress_level=1)


def host_data_zips(np, tmp: str, seed: int, card: str) -> dict:
    """Phase 16's dataset, made before phase 3 (its auto T sets the run's
    attention shapes): HOST_PAGES banner pages through ``python -m
    layoutdetr_tpu_torch.dataset_tool``, timed on the host clock."""
    from layoutdetr_tpu_torch import dataset_tool
    from layoutdetr_tpu_torch.data.dataset import LayoutDataset
    from layoutdetr_tpu_torch.train import auto_text_length

    src, dest = os.path.join(tmp, "banner_source"), os.path.join(tmp, "banner_zips")
    t0 = time.perf_counter()
    banner_source(np, src, HOST_PAGES, seed)
    source_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_train, n_val = dataset_tool.main(["--source", src, "--dest", dest])
    tool_s = time.perf_counter() - t0
    zips = {name: os.path.join(dest, name) for name in ("train.zip", "val.zip")}
    zip_bytes = {name: os.path.getsize(path) for name, path in zips.items()}
    if n_train + n_val != HOST_PAGES or n_val < 1:
        raise AssertionError(f"dataset tool kept {n_train} + {n_val} of {HOST_PAGES} pages")
    measured = LayoutDataset(zips["train.zip"], cache=False, use_native=False
                             ).measured_max_text_tokens()
    rec = dict(pages=HOST_PAGES, train=n_train, val=n_val, zip_bytes=zip_bytes,
               source_s=source_s, dataset_tool_s=tool_s, T=auto_text_length(measured),
               train_zip=zips["train.zip"], val_zip=zips["val.zip"])
    log(f"host data: {HOST_PAGES} banner pages written in {source_s:.2f} s; python -m "
        f"layoutdetr_tpu_torch.dataset_tool: {n_train} train / {n_val} val pages, zips "
        f"{zip_bytes['train.zip']} + {zip_bytes['val.zip']} bytes, {tool_s:.2f} s (host clock); "
        f"--max-text-length auto -> T={rec['T']}  [{card}]")
    return rec


def build_fastdata() -> dict:
    """The port's host decoder, ``data/csrc/fastdata.cpp``, built (g++) and
    loaded; raises if it does not build."""
    from layoutdetr_tpu_torch.data import native
    from layoutdetr_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = native.library()._name
    return dict(compiler=_build.host_compiler(), build_s=time.perf_counter() - t0, library=path)


def backgrounds(zip_paths) -> list:
    """Every ``_background_orig.png`` of the zips, as bytes."""
    import zipfile

    out = []
    for path in zip_paths:
        with zipfile.ZipFile(path) as zf:
            out += [zf.read(n) for n in zf.namelist() if n.endswith("_background_orig.png")]
    return out


def host_data_phase(torch, np, args, card, attention, bias_act_mod, tmp: str, data: dict,
                    fastdata: dict) -> dict:
    """Slice 8's path on phase 16's zips: every background decoded by the
    port's fastdata against PIL (decode exact, Lanczos to 256 within 1 level,
    mean under 0.01), the ms a background and ``warm_cache`` both ways (host
    clock), then ``train.main`` for HOST_STEPS steps through the host loader
    with native decode (bf16, batch 16, auto T) and one request served from
    its snapshot, with the launch counts set to 0 before the run and read
    after the request."""
    import io
    import statistics

    import PIL.Image

    from layoutdetr_tpu_torch import generate
    from layoutdetr_tpu_torch import train as train_cli
    from layoutdetr_tpu_torch.config import GeneratorConfig
    from layoutdetr_tpu_torch.data import native
    from layoutdetr_tpu_torch.data.dataset import LayoutDataset
    from layoutdetr_tpu_torch.training import train_loop

    t_phase = time.perf_counter()
    blobs = backgrounds((data["train_zip"], data["val_zip"]))
    if len(blobs) != HOST_PAGES:
        raise AssertionError(f"{len(blobs)} backgrounds in the zips, expected {HOST_PAGES}")
    worst_max, worst_mean = 0, 0.0
    for blob in blobs:
        img = PIL.Image.open(io.BytesIO(blob))
        dec = native.decode_png(blob)
        if dec.shape != (1024, 1024, 3) or not np.array_equal(dec, np.array(img)):
            raise AssertionError(f"native decode differs from PIL's ({dec.shape})")
        diff = np.abs(native.resize_lanczos(dec, 256).astype(np.int32)
                      - np.array(img.resize((256, 256), PIL.Image.LANCZOS)).astype(np.int32))
        worst_max, worst_mean = max(worst_max, int(diff.max())), max(worst_mean, float(diff.mean()))
    if worst_max > 1 or worst_mean >= 0.01:
        raise AssertionError(f"native Lanczos vs PIL: max {worst_max}, mean {worst_mean}")
    log(f"host data: {len(blobs)} backgrounds (1024^2 PNG), fastdata vs PIL: decode exact, "
        f"Lanczos to 256^2 max {worst_max} level, worst mean {worst_mean:.5f}")

    def ms_per_background(fn) -> float:
        times = []
        for _ in range(HOST_TIMING_PASSES):
            for blob in blobs:
                t0 = time.perf_counter()
                fn(blob)
                times.append(time.perf_counter() - t0)
        return 1e3 * statistics.median(times)

    native_ms = ms_per_background(lambda b: native.resize_lanczos(native.decode_png(b), 256))
    fused_ms = ms_per_background(lambda b: native.load_background(b, 256))
    pil_ms = ms_per_background(lambda b: np.array(
        PIL.Image.open(io.BytesIO(b)).resize((256, 256), PIL.Image.LANCZOS)))
    warm = {}
    for name, flag in (("native", True), ("pil", False)):
        ds = LayoutDataset(data["train_zip"], max_text_length=data["T"], cache=True,
                           use_native=flag)
        warm[name] = ds.warm_cache()
        del ds
    per_page = {k: v / data["train"] for k, v in warm.items()}
    rec = dict(data, fastdata=fastdata, decode_exact=True, lanczos_max_level=worst_max,
               lanczos_worst_mean=worst_mean, native_ms_per_background=native_ms,
               native_fused_ms_per_background=fused_ms, pil_ms_per_background=pil_ms,
               warm_cache_s=warm, warm_cache_s_per_page=per_page,
               warm_cache_s_at_reference_pages={k: v * REFERENCE_PAGES for k, v in per_page.items()})
    log(f"host data: ms a background (1024^2 PNG -> 256^2, median of {HOST_TIMING_PASSES} x "
        f"{len(blobs)}, host clock): fastdata {native_ms:.2f} (fused with the normalise "
        f"{fused_ms:.2f}), PIL {pil_ms:.2f}; warm_cache of {data['train']} pages "
        f"{warm['native']:.3f} s native, {warm['pil']:.3f} s PIL; derived for the reference's "
        f"{REFERENCE_PAGES} pages: {rec['warm_cache_s_at_reference_pages']['native']:.1f} s / "
        f"{rec['warm_cache_s_at_reference_pages']['pil']:.1f} s  [{card}]")

    # the training run on the tool's zip, native decode in its host loader
    decoders: list = []
    real_dataset = train_loop.LayoutDataset

    class RecordedDataset(real_dataset):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            decoders.append(self.use_native)

    out = os.path.join(tmp, "host_runs")
    torch.cuda.synchronize()
    zero_counters(attention, bias_act_mod)
    t0 = time.perf_counter()
    train_loop.LayoutDataset = RecordedDataset
    try:
        state = train_cli.main(["--outdir", out, "--data", data["train_zip"], "--batch",
                                str(args.batch), "--bf16", "--max-text-length", "auto",
                                "--device-feed", "off", "--metrics", "none", "--snap", "1",
                                "--seed", str(args.seed), "--gpus", "1",
                                "--max-steps", str(HOST_STEPS)])
    finally:
        train_loop.LayoutDataset = real_dataset
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    if decoders != [True]:
        raise AssertionError(f"the run's loader decoded natively: {decoders}")
    run_dir = os.path.join(out, os.listdir(out)[0])
    records, ticks = read_run(run_dir)
    check_ticks(records, ticks, HOST_STEPS, "host-data run")
    snap = os.path.join(run_dir, f"network-snapshot-{HOST_STEPS * args.batch // 1000:06d}.pt")
    with open(snap + ".gcfg.json") as f:
        t = GeneratorConfig.from_dict(json.load(f)).max_text_length
    if state.step != HOST_STEPS or t != data["T"]:
        raise AssertionError(f"host-data run: step {state.step}, T={t} (phase 3 checked "
                             f"{data['T']})")
    del state
    torch.cuda.empty_cache()

    # one request served from the snapshot's G_ema
    bg = os.path.join(tmp, "host_bg.png")
    with open(bg, "wb") as f:
        f.write(blobs[0])
    (layout,) = generate.main(["--ckpt", snap, "--bg", bg, "--strings", "summer sale|shop now",
                               "--string-labels", "header|button", "--device", "cuda",
                               "--outfile", os.path.join(tmp, "host_served", "banner")])
    launches = counters(attention, bias_act_mod)
    # 12 attention with dropout and 48 + 48 bias_act a main step; 12
    # deterministic a module-summary forward (G, D), an image snapshot (one
    # a tick) and the served request; 48 bias_act forward in D's summary
    want = dict(fused_attention=12 * (2 + len(ticks) + 1), fused_attention_dropout=12 * HOST_STEPS,
                bias_act=48 * HOST_STEPS + 48, bias_act_backward=48 * HOST_STEPS)
    if launches != want:
        raise AssertionError(f"host-data run: launches {launches}, expected {want}")
    if not np.isfinite(layout.bbox).all() or not ((layout.raw > 0) & (layout.raw < 1)).all():
        raise AssertionError(f"served from the host-data snapshot: {layout.raw}")
    rec.update(steps=HOST_STEPS, ticks=len(ticks), run_s=run_s,
               sec_per_kimg=records[-1]["sec_per_kimg"], launches=launches,
               served_bbox=layout.bbox[layout.mask].tolist(),
               phase_s=time.perf_counter() - t_phase)
    log(f"host data: train.main --device-feed off --batch {args.batch} --bf16 T={t} (auto), "
        f"{HOST_STEPS} steps, native decode in the host loader: {rec['sec_per_kimg']:.2f} sec/kimg "
        f"(last tick), run {run_s:.1f} s; served from its snapshot: boxes "
        f"{np.round(layout.bbox[layout.mask], 4).tolist()}; launches {launches} (as expected); "
        f"phase {rec['phase_s']:.1f} s  [{card}]")
    return rec


# ---------------------------------------------------------------------------
# 17. the driver hooks and the reference closure
# ---------------------------------------------------------------------------

DRYRUN_RANKS = 8  # dryrun_multichip(8), as a round driver calls JAX's
DRYRUN_TIMEOUT_S = 600


def hooks_attention_shapes() -> list:
    """(rows, T[, heads, head_offset, total heads]) of phase 17's attention
    calls: ``entry()``'s forward (4 x 9 texts at T=64), a dry-run rank's
    frozen text pass (2 x 3 texts at T=8, one head of 192, dropout) and
    the closure's digest forward (4 x 9 at T=256); the closure's
    evaluation makes phase 10 (b)'s calls (EVAL_WIDE_ITEMS items)."""
    return [(4 * 9, 64), (2 * 3, 8, 1, 0, 1), (4 * 9, 256)]


def dryrun_calls(torch, batch: int = 2) -> list:
    """The bias_act calls of a dry-run rank's bg_decoder forward (D at
    ``graft_entry.DRYRUN_CONFIG``: 32^2, ``batch`` samples a rank)."""
    from layoutdetr_tpu_torch.graft_entry import DRYRUN_CONFIG

    torch.manual_seed(0)
    calls, disc = bg_decoder_calls(torch, DRYRUN_CONFIG, batch, expect=None)
    del disc
    return calls


def hooks_phase(torch, np, args, card, attention, bias_act_mod, tmp: str, n_dryrun_calls: int,
                device: str = "cuda", entry_cfg=None, closure_cfg=None) -> dict:
    """Phase 17: the driver hooks and the reference closure, each counted
    from 0. (a) ``graft_entry.entry()`` on ``device`` (``GeneratorConfig()``,
    b=4, T=64): one counted ``fn`` call (12 attention launches), its time
    (CUDA events), the same weights with plain attention (phase 4's bar) and
    on the CPU (phase 4's card-vs-CPU bar). (b) ``dryrun_multichip(8)`` as a
    driver calls it, in a process of its own: the OK line, each rank's
    launches (1 dropout attention a rank, the bg_decoder's bias_act forward
    and backward), wall time and rank 0's peak memory. (c)
    ``python -m layoutdetr_tpu_torch.verify_reference --dry-run`` through
    ``verify_reference.main`` at full width: the pickle's size, the chain's
    three steps with their seconds and launches (12 a G_ema forward: the
    digest's and the evaluation's), the digest forward against the CPU on
    the same pickle and z, finite metrics and the report."""
    from layoutdetr_tpu_torch import graft_entry, verify_reference
    from layoutdetr_tpu_torch.data.dataset import LayoutDataset
    from layoutdetr_tpu_torch.metrics import layout_fid
    from layoutdetr_tpu_torch.models.generator import Generator
    from layoutdetr_tpu_torch.utils.checkpoint import generator_from_network_pkl
    from layoutdetr_tpu_torch.utils.legacy_pkl import load_network_pkl

    on_card = device == "cuda"
    t_phase = time.perf_counter()
    rec = {}

    # (a) entry()
    zero_counters(attention, bias_act_mod)
    fn, (model, batch) = graft_entry.entry(device=device, cfg=entry_cfg)
    cfg = model.cfg
    got = fn(model, batch)
    if on_card:
        torch.cuda.synchronize()
    launches = counters(attention, bias_act_mod)
    want = dict(fused_attention=cfg.bert_num_encoder_layers if on_card else 0,
                fused_attention_dropout=0, bias_act=0, bias_act_backward=0)
    if launches != want:
        raise AssertionError(f"entry(): launches {launches}, expected {want}")
    fwd_ms = cuda_ms(torch, lambda: fn(model, batch), 10)
    with torch.device(device):
        plain = Generator(cfg, flash_attention=False).eval()
    plain.load_state_dict(model.state_dict(), strict=True)
    err_plain = (fn(plain, batch) - got).abs().max().item()
    del plain
    cpu_model = Generator(cfg).eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()}, strict=True)
    err_cpu = (fn(cpu_model, {k: v.cpu() for k, v in batch.items()}) - got.cpu()).abs().max().item()
    del cpu_model, model, batch
    if (got.shape != (4, cfg.max_elements, 4) or not torch.isfinite(got).all()
            or not err_plain <= MODEL_TOL or not err_cpu <= CPU_TOL):
        raise AssertionError(f"entry(): shape {tuple(got.shape)}, max-abs {err_plain} vs plain "
                             f"attention, {err_cpu} vs the CPU")
    rec["entry"] = dict(forward_ms=fwd_ms, launches=launches, max_abs_vs_plain=err_plain,
                        max_abs_vs_cpu=err_cpu)
    log(f"entry(): Generator fp32 B=4 T=64 forward {fwd_ms:.2f} ms (CUDA events, 10 calls); "
        f"kernel vs plain attention max-abs {err_plain:.3e}, card vs CPU {err_cpu:.3e}; "
        f"launches {launches}  [{card}]")
    if on_card:
        torch.cuda.empty_cache()

    # (b) dryrun_multichip(8) as the driver calls it
    code = ("import json, sys\n"
            "from layoutdetr_tpu_torch import graft_entry\n"
            f"r = graft_entry.dryrun_multichip({DRYRUN_RANKS}, device={device!r})\n"
            "print('DRYRUN ' + json.dumps(r), flush=True)\n")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=DRYRUN_TIMEOUT_S, env=dict(os.environ, PYTHONPATH=ROOT))
    wall_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"dryrun_multichip({DRYRUN_RANKS}) failed:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-5000:]}")
    ok = [x for x in proc.stdout.splitlines() if x.startswith(f"dryrun_multichip({DRYRUN_RANKS}) OK;")]
    (res,) = [json.loads(x[len("DRYRUN "):]) for x in proc.stdout.splitlines()
              if x.startswith("DRYRUN ")]
    per_rank = dict(fused_attention=0, fused_attention_dropout=1, bias_act=n_dryrun_calls,
                    bias_act_backward=n_dryrun_calls)
    if not on_card:
        per_rank = dict.fromkeys(per_rank, 0)
    bad = [r for r in res["ranks"] if r["launches"] != per_rank or r["step"] != 1]
    if len(ok) != 1 or "step=1," not in ok[0] or len(res["ranks"]) != DRYRUN_RANKS or bad:
        raise AssertionError(f"dryrun_multichip({DRYRUN_RANKS}): OK lines {ok}, ranks off "
                             f"{bad}, expected launches a rank {per_rank}")
    dry_launches = {k: sum(r["launches"][k] for r in res["ranks"]) for k in per_rank}
    rec["dryrun"] = dict(ok_line=ok[0], backend=res["backend"], cards=res["cards"], wall_s=wall_s,
                         inner_wall_s=res["wall_s"], launches=dry_launches,
                         launches_per_rank=per_rank,
                         step_s=[r["step_s"] for r in res["ranks"]],
                         rank0_peak_memory_gb=res["ranks"][0]["peak_memory_gb"])
    log(f"{ok[0]}  (ranks on {res['cards']} card(s) over {res['backend']}; wall {wall_s:.1f} s "
        f"from the process start, {res['wall_s']:.1f} s in the call; step "
        f"{res['ranks'][0]['step_s']:.2f} s on rank 0, rank 0 peak memory "
        f"{res['ranks'][0]['peak_memory_gb'] or 0:.3f} GB; launches a rank {per_rank})  [{card}]")

    # (c) the reference closure's dry run at full width
    out = os.path.join(tmp, "closure")
    seen = {}
    zero_counters(attention, bias_act_mod)
    t0 = time.perf_counter()
    with counted_generation(layout_fid, seen):
        res = verify_reference.main(["--dry-run", out, "--device", device, "--dry-run-items",
                                     str(EVAL_WIDE_ITEMS), "--dry-run-config",
                                     json.dumps(closure_cfg or {})])
    if on_card:
        torch.cuda.synchronize()
    closure_s = time.perf_counter() - t0
    launches = counters(attention, bias_act_mod)
    forwards = 1 + seen.get("forwards", 0)  # the digest's and the evaluation's
    want = dict(fused_attention=12 * forwards if on_card else 0, fused_attention_dropout=0,
                bias_act=0, bias_act_backward=0)
    n_metrics = len(verify_reference.METRICS_REAL.split(","))
    if launches != want or forwards != 1 + n_metrics * math.ceil(EVAL_WIDE_ITEMS / args.batch):
        raise AssertionError(f"closure: launches {launches} in {forwards} G_ema forwards, "
                             f"expected {want}")
    pkl_gb = os.path.getsize(res["pkl"]) / 1e9
    gcfg = dict(res["config"])
    dataset = LayoutDataset(res["data"], background_size=gcfg["background_size"],
                            max_text_length=gcfg["max_text_length"],
                            text_len_clip=gcfg["text_len_table"])
    cpu_g = generator_from_network_pkl(load_network_pkl(res["pkl"]), "cpu",
                                       background_size=gcfg["background_size"])
    want_bbox = verify_reference.fixed_seed_forward(
        cpu_g, dataset.collate(list(range(res["bbox"].shape[0]))), torch.from_numpy(res["z"]))
    del cpu_g
    os.remove(res["pkl"])
    err = float(np.abs(res["bbox"] - want_bbox).max())
    values = res["results"]
    if (not err <= CPU_TOL or not values or not all(map(math.isfinite, values.values()))
            or not os.path.isfile(res["report"])):
        raise AssertionError(f"closure: card vs CPU bbox max-abs {err}, metrics {values}, "
                             f"report {res['report']}")
    rec["closure"] = dict(pkl_gb=pkl_gb, n_tensors=res["n_tensors"], digest=res["digest"],
                          seconds=res["seconds"], wall_s=closure_s, launches=launches,
                          forwards=forwards, bbox_max_abs_vs_cpu=err, metrics=values)
    log(f"closure (verify_reference --dry-run, GeneratorConfig() pickle {pkl_gb:.3f} GB, "
        f"{res['n_tensors']} tensors, {EVAL_WIDE_ITEMS} val items): seconds "
        + ", ".join(f"{k} {v:.2f}" for k, v in res["seconds"].items())
        + f", wall {closure_s:.1f} s; digest {res['digest']}, card vs CPU bbox max-abs {err:.3e}; "
          f"metrics " + ", ".join(f"{k} {v:.5g}" for k, v in sorted(values.items()))
        + f"; launches {launches} = 12 x {forwards} G_ema forwards  [{card}]")
    rec["launches"] = dict(driver_hooks={k: rec["entry"]["launches"][k] + dry_launches[k]
                                         for k in dry_launches}, closure=launches)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 17 (driver hooks and the reference closure): {rec['phase_s']:.1f} s  [{card}]")
    return rec


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
    ap.add_argument("--bench-host-only", action="store_true",
                    help="time the bench's train step beside phase 7's in one process, with "
                         "host and device time split, and print their JSON; prints no ok line")
    ap.add_argument("--multi-card", action="store_true",
                    help="train over every visible card (NCCL), data parallel and with "
                         "--model-parallel 2, and print their JSON; prints no ok line")
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
    if args.bench_host_only:
        return bench_host_only(torch, np, args)
    if args.multi_card:
        return multi_card_only(torch, args)

    from layoutdetr_tpu_torch.config import GeneratorConfig
    from layoutdetr_tpu_torch.generate import generate_layouts
    from layoutdetr_tpu_torch.models.generator import Generator
    from layoutdetr_tpu_torch.models.layoutganpp import LayoutGanPPConfig
    from layoutdetr_tpu_torch.ops import _build, attention
    from layoutdetr_tpu_torch.ops import bias_act as bias_act_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. device
    card = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} | nvidia-smi: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build: one compiler per source (nvcc for the kernels, g++ for the
    # host decoder), started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:
        host_build = pool.submit(build_fastdata)
        libs = list(pool.map(_build.build, ("attention", "bias_act")))
        build_s = time.perf_counter() - t0
        fastdata = host_build.result()
    log(f"build attention.cu + bias_act.cu: {build_s:.2f} s")
    for lib in libs + [fastdata["library"]]:
        with open(lib + ".log") as f:
            log(f.read().strip())
    log(f"build data/csrc/fastdata.cpp ({fastdata['compiler']}, beside nvcc): "
        f"{fastdata['build_s']:.2f} s -> {fastdata['library']}")

    # the training run's dataset, made first: its --max-text-length auto
    # bucket sets the run's attention shapes, which phase 3 checks
    workdir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    zip_path, val_path, run_t = run_dataset(workdir.name, args.seed)
    log(f"training-run dataset: {RUN_SAMPLES} samples (and a val.zip of as many), "
        f"--max-text-length auto -> T={run_t}")
    host_data = host_data_zips(np, workdir.name, args.seed, card)  # phase 16's

    # 3. kernels vs plain
    shapes = list(dict.fromkeys(serving_attention_shapes(args.batch)
                                + run_attention_shapes(args.batch, run_t)
                                + run_attention_shapes(args.batch, host_data["T"])
                                + eval_attention_shapes(args.batch, run_t)
                                + http_attention_shapes()
                                + layoutganpp_attention_shapes(args.batch)
                                + multi_gpu_attention_shapes(args.batch)
                                + hooks_attention_shapes()))
    attn_cases = attention_phase(torch, attention, args.seed, shapes)
    torch.manual_seed(args.seed)
    enc_calls = encoder_calls(torch, LayoutGanPPConfig(), args.batch)
    enc_cases = bias_act_phase(torch, bias_act_mod, enc_calls, args.seed, per="encoder forward")
    torch.cuda.empty_cache()
    cfg = GeneratorConfig()
    torch.manual_seed(args.seed)
    with torch.device("cuda"):
        model = Generator(cfg).eval()
    calls, disc = bg_decoder_calls(torch, cfg, args.batch)
    # the bg_decoder's other batches on the main paths: a data-parallel
    # rank's share and the NCCL step's 2 samples (phase 15), the module
    # summaries' 1 (phases 9, 13 and 15)
    other_batches = sorted({args.batch // MG_RANKS, 2, 1} - {args.batch}, reverse=True)
    other_calls = {b: bg_decoder_calls(torch, cfg, b, disc)[0] for b in other_batches}
    states = (model.state_dict(), {k: v.clone() for k, v in disc.state_dict().items()})
    del disc
    bias_cases = bias_act_phase(torch, bias_act_mod, calls, args.seed)
    other_bias_cases = bias_act_phase(torch, bias_act_mod,
                                      [c for cs in other_calls.values() for c in cs], args.seed,
                                      per="step at its batch")
    # phase 17's dry run: D's bg_decoder at 32^2, a rank's 2 samples
    dry_calls = dryrun_calls(torch)
    other_bias_cases += bias_act_phase(torch, bias_act_mod, dry_calls, args.seed,
                                       per="dry-run rank's step")
    round_trip = (round_trip_phase(torch, bias_act_mod, calls, args.seed)
                  + round_trip_phase(torch, bias_act_mod, other_calls[args.batch // MG_RANKS],
                                     args.seed))
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
    states_path = os.path.join(workdir.name, "states.pt")  # phase 15's weights
    torch.save([{k: v.cpu() for k, v in s.items()} for s in states], states_path)
    del states
    torch.cuda.empty_cache()

    # 9. the training run, slice 3's main path
    run = training_run_phase(torch, np, args, card, attention, bias_act_mod, workdir.name,
                             zip_path, run_t)

    # 10. evaluation, slice 4's main path
    evaluation = evaluation_phase(torch, np, args, card, attention, bias_act_mod, workdir.name,
                                  run["snapshot"], val_path, run_t)

    # 11. HTTP serving, slice 5's serving path, on phase 10 (b)'s checkpoint
    http = http_serving_phase(torch, np, args, card, attention, bias_act_mod, workdir.name,
                              evaluation["wide_ckpt"])

    # 12. the bench, slice 5's measurement path
    bench_rec = bench_phase(torch, args, card, attention, bias_act_mod)

    # 13. the ViT backbone, slice 6's paths, on phase 9's zips
    vit = vit_phase(torch, np, args, card, attention, bias_act_mod, workdir.name, zip_path,
                    val_path, run_t)

    # 14. LayoutGAN++, slice 6's other model family
    lgpp = layoutganpp_phase(torch, np, args, card, attention, bias_act_mod, len(enc_calls))

    # 15. multi-GPU training, this slice's path, on phase 9's zip
    torch.cuda.empty_cache()
    multi = multi_gpu_phase(torch, np, args, card, attention, bias_act_mod, workdir.name, zip_path,
                            run_t, states_path)

    # 16. the host data path, slice 8's: the dataset tool's zips, fastdata
    torch.cuda.empty_cache()
    host = host_data_phase(torch, np, args, card, attention, bias_act_mod, workdir.name,
                           host_data, fastdata)

    # 17. the driver hooks and the reference closure
    torch.cuda.empty_cache()
    hooks = hooks_phase(torch, np, args, card, attention, bias_act_mod, workdir.name,
                        len(dry_calls))
    workdir.cleanup()

    kernels = kernel_records(attn_cases, bias_cases, serve_launches, train, run, evaluation, http,
                             bench_rec, vit, lgpp, enc_cases, multi, other_bias_cases, host,
                             hooks)
    log(json.dumps({"serving": serving, "train": train, "step_correctness": correctness,
                    "training_run": run, "evaluation": evaluation, "http_serving": http,
                    "bench": bench_rec, "vit": vit, "layoutganpp": lgpp, "multi_gpu": multi,
                    "host_data": host, "driver_hooks": hooks,
                    "bias_act_encoder_cases": enc_cases,
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


def bg_decoder_calls(torch, cfg, batch: int, disc=None, expect: int | None = 48) -> list:
    """The arguments of the bias_act calls of one bg_decoder forward (48 at
    full width; ``expect=None`` takes any count), ``disc``'s or from seeded
    random weights, and the D."""
    from layoutdetr_tpu_torch.models.discriminator import Discriminator
    from layoutdetr_tpu_torch.ops import bias_act as bias_act_mod

    if disc is None:
        with torch.device("cuda"):
            disc = Discriminator(cfg)
    calls = []
    x0 = torch.randn(batch, cfg.hidden_dim, device="cuda")
    with recorded_bias_act_calls(bias_act_mod, calls), torch.no_grad():
        disc.bg_decoder(x0)
    if expect is not None and len(calls) != expect:
        raise AssertionError(f"{len(calls)} bias_act calls in one bg_decoder forward, "
                             f"expected {expect}")
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


def multi_card_only(torch, args) -> int:
    """``python -m layoutdetr_tpu_torch.train --gpus N`` over every visible
    card (one process a card, NCCL) at full width on phase 9's zip (bf16,
    batch 16, auto T, ADA, R1 and path length, a snapshot each tick),
    RUN_STEPS steps: on one card (what the others compare with), data
    parallel over N and with ``--model-parallel 2``; then the multi-host
    form, two torchrun "nodes" on this host (``--nnodes 2 --node-rank
    {0,1}``), each with half of the cards through ``CUDA_VISIBLE_DEVICES``
    (node 1's LOCAL_RANK 0 would otherwise land on node 0's cuda:0), data
    parallel over NCCL. After each, one request served from its snapshot
    on one card. Prints each run's sec/kimg (tick 1: steps 2-17), wall,
    rank 0's peak memory and stats as one JSON line, and no ok line."""
    from layoutdetr_tpu_torch import generate
    from layoutdetr_tpu_torch import train as train_cli
    from layoutdetr_tpu_torch.ops import _build
    from layoutdetr_tpu_torch.parallel.distributed import free_port

    card = nvidia_smi()
    n = torch.cuda.device_count()
    if n < 2:
        raise SystemExit(f"--multi-card needs at least 2 cards, {n} visible")
    log(f"multi-card: {n} x {card}")
    with ThreadPoolExecutor(max_workers=2) as pool:
        list(pool.map(_build.build, ("attention", "bias_act")))
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_multi_")
    zip_path, _, t = run_dataset(tmp.name, args.seed)
    bg = os.path.join(tmp.name, "bg.png")
    import zipfile

    with zipfile.ZipFile(zip_path) as zf, open(bg, "wb") as f:
        f.write(zf.read("00000000_background_orig.png"))
    flags = ["--data", zip_path, "--batch", str(args.batch), "--bf16", "--max-text-length", "auto",
             "--aug", "ada", "--gamma", "1", "--pl-weight", "2", "--seed", str(args.seed), "--snap",
             "1", "--metrics", "none", "--max-steps", str(RUN_STEPS)]
    runs = []

    def record(out, gpus, mp, wall_s, form):
        (run_name,) = os.listdir(out)
        run_dir = os.path.join(out, run_name)
        records = read_jsonl(os.path.join(run_dir, "stats.jsonl"))
        reports = sum(r["Loss/G/loss_Ggen"]["num"] for r in records)
        bad = [k for r in records for k, v in r.items() if isinstance(v, dict) and v["num"]
               and not (math.isfinite(v["mean"]) and math.isfinite(v["std"]))]
        if reports != gpus * RUN_STEPS or bad:
            raise AssertionError(f"{form}: {reports} main-step reports (expected "
                                 f"{gpus * RUN_STEPS}), non-finite {bad}")
        snap = os.path.join(run_dir, "network-snapshot-000000.pt")
        (layout,) = generate.main(["--ckpt", snap, "--bg", bg, "--strings", "summer sale|shop now",
                                   "--string-labels", "header|button", "--device", "cuda",
                                   "--outfile", os.path.join(out, "served", "banner")])
        if not ((layout.raw > 0) & (layout.raw < 1)).all():
            raise AssertionError(f"served from the {form} snapshot: {layout.raw}")
        last = records[-1]
        runs.append(dict(form=form, gpus=gpus, model_parallel=mp, batch=args.batch, T=t,
                         steps=RUN_STEPS, wall_s=wall_s, sec_per_kimg=last["sec_per_kimg"],
                         main_step_s=last["main_step_s"], reg_step_s=last["reg_step_s"],
                         devmem_peak_gb=max(r["devmem_peak_gb"] for r in records),
                         losses={k: v["mean"] for k, v in last.items()
                                 if isinstance(v, dict) and v["num"]}))
        log(f"{form}, bf16 batch {args.batch} T={t}, {RUN_STEPS} steps: "
            f"{last['sec_per_kimg']:.2f} sec/kimg (tick 1), wall {wall_s:.1f} s, rank 0 peak "
            f"{runs[-1]['devmem_peak_gb']:.2f} GiB; served from its snapshot  [{card}]")

    for gpus, mp in ((1, 1), (n, 1), (n, 2)):  # one card first: what the others compare with
        out = os.path.join(tmp.name, f"runs-{gpus}-{mp}")
        t0 = time.perf_counter()
        train_cli.main(["--outdir", out, *flags, "--gpus", str(gpus), "--model-parallel", str(mp)])
        record(out, gpus, mp, time.perf_counter() - t0,
               f"train --gpus {gpus} --model-parallel {mp} ({'NCCL' if gpus > 1 else 'no group'})")

    # the multi-host form: two torchrun nodes of half the cards each
    half = n // 2
    out = os.path.join(tmp.name, "runs-torchrun")
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "2", "--node-rank", str(node),
         "--nproc-per-node", str(half), "--master-addr", "127.0.0.1", "--master-port", str(port),
         "-m", "layoutdetr_tpu_torch.train", "--outdir", out, *flags],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=ROOT,
                 CUDA_VISIBLE_DEVICES=",".join(str(c) for c in range(node * half, (node + 1) * half))))
        for node in (0, 1)]
    try:
        logs = [p.communicate(timeout=1800)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise AssertionError("torchrun two-node run failed:\n" + "\n".join(x[-4000:] for x in logs))
    record(out, 2 * half, 1, time.perf_counter() - t0,
           f"torchrun --nnodes 2 --nproc-per-node {half} (NCCL, {2 * half} ranks)")
    beside = next(r for r in runs if r["gpus"] == 2 * half and r["model_parallel"] == 1
                  and r["form"].startswith("train"))
    diff = {k: v - beside["losses"][k] for k, v in runs[-1]["losses"].items() if k in beside["losses"]}
    log(f"torchrun two nodes vs {beside['form']}: sec/kimg {runs[-1]['sec_per_kimg']:.2f} against "
        f"{beside['sec_per_kimg']:.2f}; last-tick loss means differ by at most "
        f"{max(map(abs, diff.values())):.3e}  [{card}]")
    tmp.cleanup()
    print(json.dumps({"multi_card": runs, "torchrun_vs_gpus_loss_diff": diff, "card": card}),
          flush=True)
    return 0


def bench_host_only(torch, np, args, device: str = "cuda", cfg=None) -> int:
    """The bench's train step (``bench.py``'s models, batch and step) beside
    phase 7's (``new_train_state``, ``train_batch``, ``make_step``), bf16
    at ``cfg``'s T (default ``GeneratorConfig()``, T=256), in one process:
    2 warm-up steps each; rounds of 8 steps in the order bench, phase 7,
    phase 7, bench, with each step's host ms to return from the call (the
    enqueue) and to the end of a synchronize after it; a 12-step window of
    each in the same order; one profiled step each. Where the enqueue time
    equals the synced time the card finished before the host did. One JSON
    line, no ok line."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    from layoutdetr_tpu_torch import bench
    from layoutdetr_tpu_torch.config import GeneratorConfig
    from layoutdetr_tpu_torch.models.discriminator import Discriminator
    from layoutdetr_tpu_torch.models.generator import Generator
    from layoutdetr_tpu_torch.ops import _build

    on_card = device == "cuda"
    card = nvidia_smi() if on_card else "cpu"
    log(f"device: {card} | tree {ROOT}")
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=2) as pool:
            list(pool.map(_build.build, ("attention", "bias_act")))
        log(f"build attention.cu + bias_act.cu: {time.perf_counter() - t0:.2f} s")
    cfg = cfg or GeneratorConfig()
    b, t, dtype = args.batch, cfg.max_text_length, torch.bfloat16

    def sync():
        if on_card:
            torch.cuda.synchronize()

    G, D = bench.init_models(cfg, device, dtype, args.seed)
    bench_state = bench.train_state(G, D)
    bench_step = make_step(cfg, b, deterministic=False)
    bench_batch = {k: v for k, v in bench.example_batch(cfg, b, t, 16, device, args.seed).items()
                   if k != "z"}
    torch.manual_seed(args.seed)
    with torch.device(device):
        states = (Generator(cfg).state_dict(), Discriminator(cfg).state_dict())
    p7_state = new_train_state(torch, cfg, dtype, states, device)
    del states
    p7_step = make_step(cfg, b, deterministic=False)
    p7_batch = train_batch(torch, np, cfg, b, args.seed, device)
    p7_gen = torch.Generator().manual_seed(args.seed)
    n = [0]
    seen = {"bench": [], "phase7": []}

    def run_bench():
        n[0] += 1
        seen["bench"].append(bench_step(bench_state, bench_batch,
                                        torch.Generator().manual_seed(n[0])))

    def run_p7():
        seen["phase7"].append(p7_step(p7_state, p7_batch, p7_gen))

    runs = {"bench": run_bench, "phase7": run_p7}
    order = ("bench", "phase7", "phase7", "bench")
    for run in runs.values():
        run(), run()
    sync()
    rounds = {k: [] for k in runs}
    for which in order:
        for _ in range(8):
            t0 = time.perf_counter()
            runs[which]()
            t1 = time.perf_counter()
            sync()
            rounds[which].append(dict(enqueue_ms=(t1 - t0) * 1e3,
                                      synced_ms=(time.perf_counter() - t0) * 1e3))
    windows = {k: [] for k in runs}
    for which in order:
        sync()
        t0 = time.perf_counter()
        for _ in range(12):
            runs[which]()
        sync()
        windows[which].append((time.perf_counter() - t0) * 1e3 / 12)
    profiled = {}
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    for which, run in runs.items():
        with tprofile(activities=activities) as prof:
            t0 = time.perf_counter()
            run()
            sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
        summary = profile_summary(prof, wall_ms)
        calls = {e.key: dict(count=e.count, self_host_ms=e.self_cpu_time_total / 1e3)
                 for e in prof.key_averages()
                 if e.key in HOST_CALLS and e.device_type.name == "CPU"}
        profiled[which] = dict(wall_ms=wall_ms, device_busy_ms=summary["device_busy_ms"],
                               idle_share=summary["idle_share"],
                               kernel_launches=summary["kernel_launches"], host_calls=calls,
                               split=summary["split"], top_host=summary["top_host"])
    for which, stats in seen.items():
        bad = sorted({k for s in stats for k, v in s.items() if not torch.isfinite(v).all()})
        if bad:
            raise AssertionError(f"{which}: non-finite train stats {bad}")
    for which in runs:
        r, p = rounds[which], profiled[which]
        log(f"{which}: steps enqueue/synced ms "
            + " ".join(f"{x['enqueue_ms']:.1f}/{x['synced_ms']:.1f}" for x in r))
        log(f"{which}: 12-step windows ms/step {', '.join(f'{x:.2f}' for x in windows[which])}")
        log(f"{which}: profiled step wall {p['wall_ms']:.1f} ms, device busy "
            f"{p['device_busy_ms']:.1f} ms (idle share {p['idle_share']:.3f}), "
            f"{p['kernel_launches']} kernels; host calls "
            + ", ".join(f"{k} {v['count']}x {v['self_host_ms']:.2f} ms" for k, v in
                        p["host_calls"].items()) + f"  [{card}]")
    log(json.dumps({"tree": ROOT, "card": card, "batch": b, "T": t, "dtype": "bfloat16",
                    "order": order, "rounds": rounds, "windows_ms_per_step": windows,
                    "profiled": profiled}))
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
                   evaluation: dict, http: dict, bench_rec: dict, vit: dict, lgpp: dict,
                   enc_cases: list, multi: dict, other_bias_cases: list, host: dict,
                   hooks: dict) -> list:
    """The kernels line: each kernel at its representative case (fp32,
    T=256 for attention; one fp32 step's 48 bias_act calls summed), with
    the launches of each main path that runs it (``launches_by_path``) and
    their sum. Attention's two forms count apart: the dropout form under
    fused_attention_dropout (the train step's and the training run's main
    steps), the deterministic one under fused_attention (serving, the
    training run's reg steps, summaries, previews and metric ticks, the
    evaluation, the HTTP server and the bench's --infer; the bench's train
    step runs the dropout form and both bias_act kernels; the ViT's serving,
    train step and training run with its evaluation, LayoutGAN++'s
    forwards and D backward, phase 15's ranks summed over the ranks,
    phase 16's run with its served request, and phase 17's driver hooks
    (``entry()`` and the dry run's ranks summed) and reference closure,
    each a path of its own).
    bias_act's record
    also sums one LayoutGAN++ bg_encoder forward's calls
    (``per_encoder_forward``) and holds the bg_decoder's cases at the
    paths' other batches (``other_batch_cases``: max_abs_err covers
    them too)."""
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
    by_path["fused_attention"]["http_serving"] = http["launches"]
    by_path["fused_attention"]["bench_infer"] = bench_rec["infer"]["launches"]["fused_attention"]
    for k in ("fused_attention_dropout", "bias_act", "bias_act_backward"):
        by_path[k]["bench_train"] = bench_rec["train"]["launches"][k]
    vit_paths = dict(vit_serving=vit["serving"]["launches"], vit_train_step=vit["train"][0]["launches"],
                     vit_training_run=vit["training_run"]["launches"], layoutganpp=lgpp["launches"],
                     multi_gpu=multi["launches"], host_data=host["launches"],
                     driver_hooks=hooks["launches"]["driver_hooks"],
                     closure=hooks["launches"]["closure"])
    for path, launches in vit_paths.items():
        for k, n in launches.items():
            if n:
                by_path[k][path] = n
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
                        max_abs_err=max(tot[f"max_rel_err_{key}"],
                                        per_step_totals(other_bias_cases, "float32")[
                                            f"max_rel_err_{key}"]),
                        ms=tot[f"{key}_ms"],
                        plain_ms=tot[f"plain_{key}_ms"], bound_ms=tot[f"{key}_bound_ms"],
                        bound_by="bytes", library_ms=tot[f"library_{key}_ms"],
                        library_calls=tot["library_calls"],
                        ms_on_library_calls=tot[f"{key}_ms_library_calls"],
                        per_step_bfloat16=dict(ms=tot16[f"{key}_ms"],
                                               plain_ms=tot16[f"plain_{key}_ms"],
                                               bound_ms=tot16[f"{key}_bound_ms"],
                                               library_ms=tot16[f"library_{key}_ms"],
                                               ms_on_library_calls=tot16[f"{key}_ms_library_calls"]),
                        per_encoder_forward=per_step_totals(enc_cases, "float32"),
                        per_encoder_forward_bfloat16=per_step_totals(enc_cases, "bfloat16"),
                        encoder_cases=enc_cases, other_batch_cases=other_bias_cases,
                        note="ms, plain_ms and bound_ms sum one step's 48 calls; library_ms "
                             "sums only the library_calls calls that are linear with gain 1 and "
                             "no clamp (torch.add forward, torch.sum of dy for db backward), "
                             "beside the kernel's ms_on_library_calls on the same calls; the "
                             "lrelu calls have no library call (none); max_abs_err is relative "
                             "to max |y| (|dx|, |db|); per_encoder_forward sums one LayoutGAN++ "
                             "bg_encoder forward's calls the same way (its linear skip's library "
                             "call is torch.add(gain * b, x, alpha=gain) forward, none backward)"))
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
