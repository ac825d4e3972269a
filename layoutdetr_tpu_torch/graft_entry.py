"""Driver entry points: the Generator forward as ``(fn, args)`` and a
multi-rank dry run of one whole GAN train step.

Counterpart of the root ``__graft_entry__.py`` (the hooks a round driver
calls, RELEASE.md:3-5):

    from layoutdetr_tpu_torch import graft_entry
    fn, args = graft_entry.entry()           # G at GeneratorConfig(), on cuda
    bbox = fn(*args)                         # [4, 9, 4]
    graft_entry.dryrun_multichip(8)          # one train step over 8 ranks

Both run on the card unless the caller passes ``device="cpu"``; with no
CUDA device and no ``device="cpu"`` both raise. Nothing moves to the CPU
on its own.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from layoutdetr_tpu_torch.config import GeneratorConfig

# The dry run's model: JAX's dryrun config (``__graft_entry__.py:190-206``)
# but for one thing. JAX's text encoder there is 32 wide with 2 heads, a
# head dim of 16, which the fused attention kernel does not take (it is
# built for 192, ``ops/attention.py``); at 192 wide with one head the
# frozen text pass launches the kernel on the card.
DRYRUN_CONFIG = GeneratorConfig(
    hidden_dim=16, bert_f_dim=192, bert_num_heads=1, bert_num_encoder_layers=1,
    bert_num_decoder_layers=1, im_f_dim=16, max_text_length=16, vocab_size=64, bos_token_id=62,
    nhead=2, num_encoder_layers=1, num_decoder_layers=1, reconst_decoder_layers=1,
    uncond_encoder_layers=1, backbone_stage_sizes=(1, 1, 1, 1), dim_feedforward=32,
    background_size=32, max_elements=3)
DRYRUN_TEXT_LENGTH = 8  # JAX's dryrun batch's T
RANK_TIMEOUT_S = 900


def _example_batch(gcfg, b, t, s, seed=0):
    """The driver's example inputs: the numpy draws of
    ``__graft_entry__._example_batch``, in the same order."""
    rng = np.random.default_rng(seed)
    n = gcfg.max_elements
    return dict(
        z=rng.normal(size=(b, n, gcfg.z_dim)).astype(np.float32),
        bbox_class=rng.integers(0, gcfg.num_bbox_labels, size=(b, n)),
        bbox_real=rng.uniform(0.1, 0.9, size=(b, n, 4)).astype(np.float32),
        text_ids=rng.integers(1, min(gcfg.vocab_size - 4, 30000), size=(b, n, t)),
        text_mask=np.ones((b, n, t), np.int32),
        text_len=rng.integers(0, gcfg.max_text_length, size=(b, n)),
        padding_mask=np.zeros((b, n), bool),
        background=rng.normal(size=(b, s, s, 3)).astype(np.float32),
    )


def to_tensors(batch: dict, device) -> dict:
    """``_example_batch``'s arrays as the Generator takes them on
    ``device``: ids and lengths ``long``, the masks as drawn (int32 text
    mask, bool padding mask), the background channels last."""
    out = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    for k in ("bbox_class", "text_ids", "text_len"):
        out[k] = out[k].long()
    return out


def _device(device: Optional[str]) -> torch.device:
    """``device``, ``cuda`` by default; a card that is not there raises."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the driver hooks run on the card "
                           "(pass device='cpu' to run them on the CPU)")
    return dev


def entry(device: Optional[str] = None, cfg: Optional[GeneratorConfig] = None):
    """``(fn, (model, batch))``: the Generator forward at ``reconst=False``.

    ``model`` is ``Generator(cfg)`` (``GeneratorConfig()`` by default,
    weights from seed 0) in eval mode on ``device`` (``cuda`` unless the
    caller asks for ``cpu``); ``batch`` is ``_example_batch`` at b=4, T=64
    and the config's background size, as tensors there. ``fn(model,
    batch)`` runs the forward under ``torch.no_grad()`` and returns
    ``bbox_fake`` [4, max_elements, 4]. At the default config the frozen
    BERT runs ``fused_attention`` 12 times a call, on [36, 4, 64, 192]."""
    from layoutdetr_tpu_torch.models.generator import Generator

    dev = _device(device)
    cfg = cfg or GeneratorConfig()
    torch.manual_seed(0)
    with torch.device(dev):
        model = Generator(cfg).eval()
    batch = to_tensors(_example_batch(cfg, b=4, t=64, s=cfg.background_size), dev)

    def fn(model, batch):
        with torch.no_grad():
            return model(**batch, reconst=False)

    return fn, (model, batch)


def _ranks_layout(n: int, dev: torch.device) -> tuple:
    """(devices, backend, cards) of ``n`` ranks: one card each over NCCL
    when ``n`` are visible, else round robin over the visible cards over
    gloo (NCCL refuses two ranks on one device); CPU ranks over gloo."""
    if dev.type == "cpu":
        return ["cpu"] * n, "gloo", 0
    visible = torch.cuda.device_count()
    if visible >= n:
        return [f"cuda:{r}" for r in range(n)], "nccl", n
    return [f"cuda:{r % visible}" for r in range(n)], "gloo", visible


def dryrun_multichip(n_devices: int, device: Optional[str] = None) -> dict:
    """One whole GAN train step (Gmain, Dmain, Adam, EMA, the hoisted
    frozen text pass with dropout) over ``n_devices`` data-parallel ranks,
    from rank 0's weights broadcast to all, at ``DRYRUN_CONFIG`` (JAX's
    dryrun config with a 192-wide one-head text encoder), batch
    ``2 * n_devices``, each rank its 2 rows of ``_example_batch``. Then
    the replica check (``utils.misc.check_replica_consistency``), and rank
    0 prints the closing line::

        dryrun_multichip(n) OK; grid={'data': n, 'model': 1}, backend=..., cards=..., step=1, Dreal=...

    Ranks (``parallel.distributed.spawn``): one a card over NCCL when
    ``n_devices`` cards are visible, else sharing the visible cards round
    robin over gloo; CPU ranks over gloo only for ``device="cpu"``. The
    kernels are built here once, before the ranks start. Returns each
    rank's record (launch counts, Dreal, step seconds, peak memory) with
    the backend, the cards and the wall seconds."""
    dev = _device(device)
    t0 = time.perf_counter()
    devices, backend, cards = _ranks_layout(n_devices, dev)
    if dev.type == "cuda":
        from layoutdetr_tpu_torch.ops import _build

        for name in ("attention", "bias_act"):
            _build.build(name)
    from layoutdetr_tpu_torch.parallel import distributed

    with tempfile.TemporaryDirectory(prefix="dryrun_multichip_") as out:
        distributed.spawn(_dryrun_rank, n_devices, (out, n_devices, backend, cards),
                          devices=devices, backend=backend, timeout_s=RANK_TIMEOUT_S)
        ranks = []
        for r in range(n_devices):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    return dict(n=n_devices, backend=backend, cards=cards, ranks=ranks,
                wall_s=time.perf_counter() - t0)


def _dryrun_rank(out: str, n: int, backend: str, cards: int) -> None:
    """One rank of ``dryrun_multichip``, inside its grid."""
    from layoutdetr_tpu_torch.models.discriminator import Discriminator
    from layoutdetr_tpu_torch.models.generator import Generator
    from layoutdetr_tpu_torch.ops import attention
    from layoutdetr_tpu_torch.ops import bias_act
    from layoutdetr_tpu_torch.parallel import distributed
    from layoutdetr_tpu_torch.training.optimizers import build_optimizer
    from layoutdetr_tpu_torch.training.train_step import GANTrainState, make_train_step
    from layoutdetr_tpu_torch.utils.misc import check_replica_consistency

    g = distributed.grid()
    dev, cfg, b = g.device, DRYRUN_CONFIG, 2 * n
    on_card = dev.type == "cuda"
    np_batch = _example_batch(cfg, b=b, t=DRYRUN_TEXT_LENGTH, s=cfg.background_size)
    share = b // g.dp_size
    full = to_tensors(np_batch, dev)
    rows = slice(g.dp_rank * share, (g.dp_rank + 1) * share)
    batch = dict(bboxes=full["bbox_real"], labels=full["bbox_class"], text_ids=full["text_ids"],
                 text_mask=full["text_mask"], text_len=full["text_len"],
                 mask=~full["padding_mask"], background=full["background"])
    batch = {k: v[rows] for k, v in batch.items()}

    torch.manual_seed(g.rank)  # the ranks' own draws; rank 0's are broadcast
    with torch.device(dev):
        G, D = Generator(cfg), Discriminator(cfg)
    distributed.broadcast_module_(G)
    distributed.broadcast_module_(D)
    opt_g = build_optimizer(G.train(), reg_interval=4)
    opt_d = build_optimizer(D.train(), reg_interval=16)
    state = GANTrainState.create(G, D, opt_g, opt_d)
    step = make_train_step(batch_size=b, z_dim=cfg.z_dim, max_elements=cfg.max_elements)
    gen = torch.Generator().manual_seed(distributed.rank_seed(1, g.dp_rank))

    for k in attention.LAUNCHES:
        attention.LAUNCHES[k] = 0
    for k in bias_act.LAUNCHES:
        bias_act.LAUNCHES[k] = 0
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    stats = step(state, batch, gen)
    if on_card:
        torch.cuda.synchronize(dev)
    step_s = time.perf_counter() - t0
    launches = dict(fused_attention=attention.LAUNCHES["fused_attention"],
                    fused_attention_dropout=attention.LAUNCHES["fused_attention_dropout"],
                    bias_act=bias_act.LAUNCHES["forward"],
                    bias_act_backward=bias_act.LAUNCHES["backward"])
    check_replica_consistency({"G": state.G, "D": state.D, "G_ema": state.G_ema})
    losses = {k: float(v) for k, v in stats.items()}
    bad = [k for k, v in losses.items() if not np.isfinite(v)]
    if bad:
        raise FloatingPointError(f"dryrun rank {g.rank}: non-finite {bad}")
    # the global batch's mean: the ranks hold equal shares
    dreal = distributed.all_reduce_host([losses["Loss/D/loss_Dreal"]])[0] / g.world
    rec = dict(rank=g.rank, device=str(dev), step=state.step, dreal=dreal, step_s=step_s,
               launches=launches,
               peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else None)
    with open(os.path.join(out, f"rank{g.rank}.json"), "w") as f:
        json.dump(rec, f)
    if g.is_chief:
        print(f"dryrun_multichip({n}) OK; grid={{'data': {g.dp_size}, 'model': {g.tp_size}}}, "
              f"backend={backend}, cards={cards}, step={state.step}, Dreal={dreal:.4f}",
              flush=True)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8,
                     sys.argv[2] if len(sys.argv) > 2 else None)
