"""Rank functions of the port's multi-process tests (``test_torch_parallel*.py``).

Each runs inside a rank spawned by
``layoutdetr_tpu_torch.parallel.distributed.spawn`` (gloo on the CPU),
reads its case from ``spec`` (a ``torch.save`` file the test wrote) and
writes what it saw to ``<out>/rank<r>.pt``. Imports torch and the port
only: a spawned rank starts in a few seconds.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from layoutdetr_tpu_torch.config import GeneratorConfig
from layoutdetr_tpu_torch.models.discriminator import Discriminator
from layoutdetr_tpu_torch.models.generator import Generator, make_text_feature_fn
from layoutdetr_tpu_torch.parallel import distributed
from layoutdetr_tpu_torch.parallel import tensor_parallel as tp
from layoutdetr_tpu_torch.training import train_loop
from layoutdetr_tpu_torch.training.loss import LossWeights, d_main_loss, g_main_loss
from layoutdetr_tpu_torch.training.optimizers import build_optimizer
from layoutdetr_tpu_torch.training.train_step import (
    GANTrainState,
    make_d_reg_step,
    make_g_reg_step,
    make_train_step,
)
from layoutdetr_tpu_torch.utils.misc import check_replica_consistency
from layoutdetr_tpu_torch.utils.stats import Collector

def _save(out: str, obj) -> None:
    torch.save(obj, os.path.join(out, f"rank{distributed.grid().rank}.pt"))


def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _rows(x, grid, n: int):
    """Data rank ``grid.dp_rank``'s rows of a global batch of ``n``."""
    share = n // grid.dp_size
    return x[grid.dp_rank * share:(grid.dp_rank + 1) * share]


def new_state(cfg: GeneratorConfig, states) -> GANTrainState:
    """G and D from the full state dicts, optimizers, sharded by the grid."""
    g = distributed.grid()
    G, D = Generator(cfg), Discriminator(cfg)
    G.load_state_dict(states[0], strict=True)
    D.load_state_dict(states[1], strict=True)
    opt_g = build_optimizer(G.train(), reg_interval=4)
    opt_d = build_optimizer(D.train(), reg_interval=16)
    distributed.broadcast_module_(G)
    distributed.broadcast_module_(D)
    tp.shard_module_(G, g.tp_rank, g.tp_size)
    tp.shard_module_(D, g.tp_rank, g.tp_size)
    return GANTrainState.create(G, D, opt_g, opt_d)


def full_sd(module) -> dict:
    """A copy of ``module``'s state dict with the full tensors (collective)."""
    g = distributed.grid()
    full = tp.gather_state_dict(module.state_dict(), g.tp_rank, g.tp_size, g.tp_group)
    return {k: v.detach().clone() for k, v in full.items()}


def phase_grads(cfg, states, batch: dict, z: tuple) -> dict:
    """Gmain's and Dmain's losses and gradients on this rank's share,
    averaged over the data ranks (full tensors, by parameter name)."""
    g = distributed.grid()
    state = new_state(cfg, states)
    tf = make_text_feature_fn(state.G.text_encoder)(batch["text_ids"], batch["text_mask"])
    mb = dict(batch, text_feat_g=tf, text_feat_d=tf)
    out = {}
    for phase, fn, module, zz in (("g_main", g_main_loss, state.G, z[0]),
                                  ("d_main", d_main_loss, state.D, z[1])):
        total, _ = fn(state.G, state.D, mb, zz, LossWeights(), True)
        names = [n for n, p in module.named_parameters() if p.requires_grad]
        params = [p for p in module.parameters() if p.requires_grad]
        grads = list(torch.autograd.grad(total, params, allow_unused=True))
        distributed.average_gradients(grads, params)
        sd = {n: gr for n, gr in zip(names, grads) if gr is not None}
        out[phase] = dict(total=float(total.detach()),
                          grads=tp.gather_state_dict(sd, g.tp_rank, g.tp_size, g.tp_group))
    return out


def step_case(spec_path: str, out: str) -> None:
    """One train step of the spec's global batch on this rank's share, with
    this rank's slice of the spec's z (the one-process step's z); then
    the gradients of each phase (``phase_grads``), the collector, and the
    replica check."""
    spec = torch.load(spec_path, weights_only=False)
    g = distributed.grid()
    cfg, states, n = spec["cfg"], spec["states"], spec["batch_size"]
    batch = {k: _rows(v, g, n) for k, v in _torch(spec["batch"]).items()}
    z = tuple(_rows(torch.from_numpy(np.array(x)), g, n) for x in spec["z"])
    rec = {}
    if spec.get("grads"):
        rec["grads"] = phase_grads(cfg, states, batch, z)

    state = new_state(cfg, states)
    step = make_train_step(batch_size=n, z_dim=cfg.z_dim, max_elements=cfg.max_elements,
                           deterministic=spec["deterministic"])
    gen = torch.Generator().manual_seed(distributed.rank_seed(0, g.dp_rank))
    stats = step(state, batch, gen, z=z)
    rec["stats"] = {k: float(v) for k, v in stats.items()}
    rec["G"], rec["D"], rec["G_ema"] = full_sd(state.G), full_sd(state.D), full_sd(state.G_ema)
    check_replica_consistency({"G": state.G, "D": state.D, "G_ema": state.G_ema})

    # the collector's cross-rank sum (test_multihost.py:74-79)
    c = Collector()
    c.report("a", [1.0, 1.0] if g.rank == 0 else [2.0, 2.0])
    c.update()
    rec["collector"] = (c.mean("a"), c.num("a"))

    # the replica check: a divergent replicated tensor raises on every
    # rank; under TP a divergent shard of a sharded tensor does not
    with torch.no_grad():
        if g.tp_size > 1:
            state.G.text_decoder.bert.encoder.layer[0].attention.self.query.weight.add_(g.rank)
            check_replica_consistency({"G": state.G})
            rec["shard_skipped"] = True
        if g.rank == g.world - 1:
            state.G.fc_z.bias[0] += 1.0
        try:
            check_replica_consistency({"G": state.G})
            rec["mismatch"] = None
        except AssertionError as e:
            rec["mismatch"] = str(e)
    _save(out, rec)


def reg_case(spec_path: str, out: str) -> None:
    """The path-length step on this rank's batch (its first half, with the
    spec's z and noise for those samples), then the R1 step."""
    spec = torch.load(spec_path, weights_only=False)
    g = distributed.grid()
    cfg = spec["cfg"]
    state = new_state(cfg, spec["states"])
    batch = {k: _rows(v, g, spec["batch_size"]) for k, v in _torch(spec["batch"]).items()}
    shrink = spec["batch_size"] // g.dp_size // 2
    z = torch.from_numpy(spec["z"])[g.dp_rank * shrink:(g.dp_rank + 1) * shrink]
    noise = torch.from_numpy(spec["noise"])[g.dp_rank * shrink:(g.dp_rank + 1) * shrink]
    weights = LossWeights(pl_weight=2.0, r1_gamma=1.0)
    stats = make_g_reg_step(weights, cfg.z_dim, cfg.max_elements)(
        state, batch, torch.Generator(), z=z, pl_noise=noise)
    stats.update(make_d_reg_step(weights)(state, batch))
    _save(out, dict(stats={k: float(v) for k, v in stats.items()}, pl_mean=float(state.pl_mean),
                    G=full_sd(state.G), D=full_sd(state.D)))


def loop_case(spec_path: str, out: str) -> None:
    """``training_loop`` on this rank with the spec's arguments; records
    ADA's p at every update and the final step."""
    spec = torch.load(spec_path, weights_only=False)
    seen = []
    real = train_loop.AdaController.update

    def update(self, *a):
        p = real(self, *a)
        seen.append(p)
        return p

    train_loop.AdaController.update = update
    try:
        state = train_loop.training_loop(**spec["kwargs"])
    finally:
        train_loop.AdaController.update = real
    _save(out, dict(ada_p=seen, step=state.step, pl_mean=float(state.pl_mean)))
