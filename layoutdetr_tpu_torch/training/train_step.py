"""The GAN train steps: the main step (hoisted text pass, Gmain -> Adam ->
Dmain -> Adam -> EMA) and the lazy-regularization steps.

Counterpart of ``layoutdetr_tpu/training/train_step.py`` (reference
training_loop.py:274-332). One call of the main step:

1. the frozen text encoder's CLS features, computed once without
   gradients by G's encoder (``make_text_feature_fn``: the fused attention
   kernel with its dropout form) and fed to G and D alike: JAX's
   ``text_feature_fn`` with ``share_text_encoder=True``, which bench.py
   and the training loop run when G's and D's frozen encoders hold the
   same weights (D's own is then not run by the step; otherwise it makes
   a second pass);
2. Gmain: ``g_main_loss`` differentiated with respect to G's trainable
   parameters only; the gradients are sanitized (``_sanitize``) and G's
   Adam steps;
3. Dmain with a fresh z: ``d_main_loss`` (G under no_grad) differentiated
   with respect to D's trainable parameters; sanitize; D's Adam steps;
4. EMA of G into ``G_ema`` with the half-life schedule ``ema_beta``,
   skipping frozen parameters (their lerp is the identity: they never
   move and started equal).

Each part runs inside a span (``utils.profiling.span``) named
``train_step.<part>`` (text, Gmain, G_adam, Dmain, D_adam, ema), so a
profiled step shows where its time goes. Inside Gmain and Dmain,
``train_step.forward`` holds the loss's forward and ``train_step.backward``
its ``autograd.grad`` (the kernels autograd's device thread launches meanwhile
count there by launch time); inside G_adam and D_adam,
``train_step.sanitize`` holds ``_sanitize``, beside torch's own
``Optimizer.step#Adam.step``. When no profiler records, a span costs one
flag check.

Data parallelism (``parallel.distributed``): each rank runs the step on
its share of the global batch, with its own generator; each phase's
gradients are averaged over the ranks (``average_gradients``: over the
data ranks, and a model group's copies of a replicated one kept equal)
between the backward and Adam, in the main and the reg steps, so every
rank applies the global gradient. ``batch_size`` is the global batch (the EMA
half-life counts it). Under tensor parallelism the sharded layers carry
their own collectives (``parallel.tensor_parallel``).

``grad_accum`` > 1 splits each phase's batch into microbatches and
averages their gradients. The state is updated in place (the modules and
optimizers are the state), where JAX returns a new state; the step
returns the stats as 0-dim tensors on the device.

Randomness comes from one CPU ``torch.Generator`` passed to the step:
z, the dropout masks of every forward, the attention seeds and the ADA
draws come from it (device generators are seeded from host draws), so a
step needs no device sync. ``z`` lets a caller hand in (z for Gmain, z
for Dmain), e.g. the ones the JAX step draws; the main path leaves it
None. A batch may carry ``aug_p`` (a float): D's critic inputs are then
ADA-augmented (``loss._augmented``).

The lazy-regularization steps (``make_g_reg_step``, ``make_d_reg_step``;
JAX's :245-289) run on their intervals with the loss scaled by the
interval. Each hands its loss the frozen encoder's feature function (G's
for the path-length step, D's for R1), so the loss computes the text
features of the samples it uses once, deterministic and without
gradients: the features depend neither on z nor on the bbox, and the
pass runs the fused attention kernel, where a grad-enabled encoder would
run the plain version. Then the penalty's double backward, the
sanitized gradients (zeros where a trainable parameter takes no part, as
optax sees them) and the phase's Adam.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from layoutdetr_tpu_torch.models.generator import make_text_feature_fn
from layoutdetr_tpu_torch.parallel.distributed import average_gradients
from layoutdetr_tpu_torch.training.augment import AugmentConfig
from layoutdetr_tpu_torch.training.loss import (
    LossWeights,
    d_main_loss,
    d_r1_loss,
    fork_generator,
    g_main_loss,
    g_pl_loss,
)
from layoutdetr_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class GANTrainState:
    G: nn.Module
    D: nn.Module
    G_ema: nn.Module
    opt_g: torch.optim.Optimizer
    opt_d: torch.optim.Optimizer
    pl_mean: torch.Tensor  # 0-dim, on the models' device
    step: int = 0

    @classmethod
    def create(cls, G: nn.Module, D: nn.Module, opt_g: torch.optim.Optimizer,
               opt_d: torch.optim.Optimizer) -> "GANTrainState":
        G_ema = copy.deepcopy(G).eval().requires_grad_(False)
        pl_mean = torch.zeros((), device=next(G.parameters()).device)
        return cls(G=G, D=D, G_ema=G_ema, opt_g=opt_g, opt_d=opt_d, pl_mean=pl_mean)


def _sanitize(grads: Sequence[Optional[torch.Tensor]]) -> None:
    """nan_to_num on every gradient, in place (training_loop.py:309 parity)."""
    for g in grads:
        if g is not None:
            torch.nan_to_num_(g, nan=0.0, posinf=1e5, neginf=-1e5)


def ema_beta(batch_size: int, ema_kimg: float, cur_nimg: float,
             ema_rampup: Optional[float] = 0.05) -> float:
    """EMA half-life schedule (training_loop.py:320-324)."""
    ema_nimg = ema_kimg * 1000.0
    if ema_rampup is not None:
        ema_nimg = min(ema_nimg, cur_nimg * ema_rampup)
    return 0.5 ** (batch_size / max(ema_nimg, 1e-8))


def _trainable(module: nn.Module) -> list:
    return [p for p in module.parameters() if p.requires_grad]


def _accum_phase(loss_fn: Callable, params: list, batch: Dict[str, torch.Tensor], grad_accum: int,
                 zs: Sequence[torch.Tensor], generator) -> Tuple[list, dict]:
    """Gradients of ``loss_fn(mb, z, generator)`` w.r.t. ``params``,
    averaged over ``grad_accum`` microbatches; stats averaged likewise."""
    mb_size = batch["labels"].shape[0] // grad_accum
    grads: list = [None] * len(params)
    stats: dict = {}
    for i in range(grad_accum):
        mb = {k: v[i * mb_size:(i + 1) * mb_size] if isinstance(v, torch.Tensor) else v
              for k, v in batch.items()}
        with span("train_step.forward"):
            total, mb_stats = loss_fn(mb, zs[i], generator)
        with span("train_step.backward"):
            mb_grads = torch.autograd.grad(total, params, allow_unused=True)
        for j, g in enumerate(mb_grads):
            if g is not None:
                grads[j] = g if grads[j] is None else grads[j] + g
        for k, v in mb_stats.items():
            stats[k] = v.detach() if k not in stats else stats[k] + v.detach()
    if grad_accum > 1:
        grads = [None if g is None else g / grad_accum for g in grads]
        stats = {k: v / grad_accum for k, v in stats.items()}
    return grads, stats


def _apply(opt: torch.optim.Optimizer, params: list, grads: list) -> None:
    """The DP average of ``grads``, sanitized, into ``opt``'s step."""
    average_gradients(grads, params)
    with span("train_step.sanitize"):
        _sanitize(grads)
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    opt.zero_grad(set_to_none=True)


def make_train_step(weights: LossWeights = LossWeights(), batch_size: int = 16,
                    ema_kimg: Optional[float] = None, ema_rampup: Optional[float] = 0.05,
                    z_dim: int = 4, max_elements: int = 9, deterministic: bool = False,
                    grad_accum: int = 1, aug_cfg: Optional[AugmentConfig] = None,
                    share_text_encoder: bool = True):
    """Returns ``step(state, batch, generator, z=None) -> stats``.

    ``generator``: a CPU torch.Generator. ``batch``: tensors on the models'
    device, keys bboxes, labels, text_ids, text_mask, text_len, mask
    (True = valid), background; optionally ``aug_p`` (float), the ADA
    probability, with ``aug_cfg`` its groups (default CONDITIONAL_SAFE).
    ``share_text_encoder=False`` runs D's own frozen encoder for D's text
    features (G's and D's encoders hold different weights)."""
    if ema_kimg is None:
        ema_kimg = batch_size * 10 / 32  # train.py:249

    def step(state: GANTrainState, batch: Dict[str, torch.Tensor], generator: torch.Generator,
             z: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> dict:
        dev = batch["labels"].device
        b = batch["labels"].shape[0]
        if b % grad_accum:
            raise ValueError(f"batch {b} does not split into {grad_accum} microbatches")

        with span("train_step.text"):
            text_feat = make_text_feature_fn(state.G.text_encoder)(
                batch["text_ids"], batch["text_mask"], deterministic, generator)
            text_feat_d = text_feat if share_text_encoder else make_text_feature_fn(
                state.D.text_encoder)(batch["text_ids"], batch["text_mask"], deterministic, generator)
        batch = dict(batch, text_feat_g=text_feat, text_feat_d=text_feat_d)

        def draw_z():
            zgen = fork_generator(generator, dev)
            return torch.randn(b, max_elements, z_dim, device=dev, generator=zgen)

        def split_z(full):
            return full.chunk(grad_accum) if grad_accum > 1 else (full,)

        with span("train_step.Gmain"):
            z_g = draw_z() if z is None else z[0]
            params_g = _trainable(state.G)
            g_grads, g_stats = _accum_phase(
                lambda mb, zz, gen: g_main_loss(state.G, state.D, mb, zz, weights, deterministic,
                                                gen, aug_cfg),
                params_g, batch, grad_accum, split_z(z_g), generator)
        with span("train_step.G_adam"):
            _apply(state.opt_g, params_g, g_grads)

        # Dmain: a fresh z, the reference's per-phase z
        with span("train_step.Dmain"):
            z_d = draw_z() if z is None else z[1]
            params_d = _trainable(state.D)
            d_grads, d_stats = _accum_phase(
                lambda mb, zz, gen: d_main_loss(state.G, state.D, mb, zz, weights, deterministic,
                                                gen, aug_cfg),
                params_d, batch, grad_accum, split_z(z_d), generator)
        with span("train_step.D_adam"):
            _apply(state.opt_d, params_d, d_grads)

        # EMA (training_loop.py:320-328), trainable parameters only
        beta = ema_beta(batch_size, ema_kimg, (state.step + 1) * batch_size, ema_rampup)
        with span("train_step.ema"), torch.no_grad():
            pairs = [(e, p) for e, p in zip(state.G_ema.parameters(), state.G.parameters())
                     if p.requires_grad]
            ema = [e for e, _ in pairs]
            cur = [p for _, p in pairs]
            torch._foreach_sub_(ema, cur)  # e <- (e - p) * beta + p, in place
            torch._foreach_mul_(ema, beta)
            torch._foreach_add_(ema, cur)
        state.step += 1
        return {**g_stats, **d_stats}

    return step


def _reg_update(opt: torch.optim.Optimizer, module: nn.Module, loss: torch.Tensor) -> None:
    """Adam on the gradients of ``loss`` w.r.t. ``module``'s trainable
    parameters, sanitized, zeros where a parameter takes no part (optax
    counts such a step and decays its moments; torch's Adam would skip a
    parameter without a gradient)."""
    params = _trainable(module)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    _apply(opt, params, [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)])


def make_g_reg_step(weights: LossWeights, z_dim: int = 4, max_elements: int = 9,
                    gain: float = 4.0):
    """The path-length step (JAX's :245-269): returns ``step(state, batch,
    generator, z=None, pl_noise=None) -> stats``, run every G reg interval
    batches with the loss scaled by ``gain`` = the interval."""

    def step(state: GANTrainState, batch: Dict[str, torch.Tensor], generator: torch.Generator,
             z: Optional[torch.Tensor] = None, pl_noise: Optional[torch.Tensor] = None) -> dict:
        with span("g_reg.pl"):
            loss, pl_mean, stats = g_pl_loss(state.G, batch, weights, state.pl_mean, z, pl_noise,
                                             generator, make_text_feature_fn(state.G.text_encoder))
            _reg_update(state.opt_g, state.G, loss * gain)
        state.pl_mean = pl_mean
        return stats

    return step


def make_d_reg_step(weights: LossWeights, gain: float = 16.0):
    """The R1 step (JAX's :272-289): returns ``step(state, batch,
    generator=None) -> stats``, run every D reg interval batches with the
    loss scaled by ``gain`` = the interval. Deterministic: draws nothing."""

    def step(state: GANTrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None) -> dict:
        del generator
        with span("d_reg.r1"):
            loss, stats = d_r1_loss(state.D, batch, weights, make_text_feature_fn(state.D.text_encoder))
            _reg_update(state.opt_d, state.D, loss * gain)
        return stats

    return step
