"""The GAN train step in plain PyTorch, the weights made from a seed, and
the frozen parameter set.

One step: the frozen text encoder's CLS features once, without gradients
(shared by G and D); Gmain and G's Adam; Dmain with a fresh z and D's Adam;
then the EMA of G's trainable parameters into G_ema. Every random draw comes
from the step's CPU ``torch.Generator`` in the order the program's step
takes it: the text pass's seeds, z for Gmain, one device generator per
forward, z for Dmain.

Adam is written out (betas (0, 0.99) and lr 1e-5, both scaled by the lazy
regularization ratio I / (I + 1) with I = 4 for G and 16 for D, eps 1e-8
outside the square root), as StyleGAN2's training loop sets it up.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from .config import GeneratorConfig
from .discriminator import Discriminator
from .generator import Generator, make_text_feature_fn
from .loss import LossWeights, d_main_loss, fork_generator, g_main_loss

FROZEN_PREFIXES: Tuple[str, ...] = (
    "text_encoder.",
    "backbone.0.body.conv1.", "backbone.0.body.bn1.", "backbone.0.body.layer1.",
)
G_REG_INTERVAL, D_REG_INTERVAL = 4, 16


def make_models(cfg: GeneratorConfig, seed: int, device) -> Tuple[Generator, Discriminator]:
    """G and D with random weights from ``seed``, made on ``device``: the
    global generator is seeded and every module initializes its own
    parameters there, G's first and then D's."""
    torch.manual_seed(seed)
    with torch.device(device):
        return Generator(cfg), Discriminator(cfg)


def make_generator(cfg: GeneratorConfig, seed: int, device) -> Generator:
    """G alone, with the weights ``make_models`` gives it."""
    torch.manual_seed(seed)
    with torch.device(device):
        return Generator(cfg)


def trainable(module: nn.Module, frozen: Sequence[str] = FROZEN_PREFIXES) -> List[Tuple[str, nn.Parameter]]:
    """(name, parameter) of every parameter outside the frozen set, in
    ``named_parameters`` order."""
    return [(n, p) for n, p in module.named_parameters() if not n.startswith(tuple(frozen))]


class Adam:
    """Adam over ``params`` with bias-corrected moments."""

    def __init__(self, params: Sequence[torch.Tensor], reg_interval: int, lr: float = 1e-5,
                 betas: Tuple[float, float] = (0.0, 0.99), eps: float = 1e-8):
        ratio = reg_interval / (reg_interval + 1)
        self.params = list(params)
        self.lr = lr * ratio
        self.b1, self.b2 = (b ** ratio for b in betas)
        self.eps = eps
        self.t = 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(self.lr / c1 * m / (v.sqrt() / math.sqrt(c2) + self.eps))


def ema_beta(batch_size: int, ema_kimg: float, cur_nimg: float, ema_rampup: float = 0.05) -> float:
    """EMA half-life schedule with ramp-up (StyleGAN2 training_loop.py:320-324)."""
    ema_nimg = min(ema_kimg * 1000.0, cur_nimg * ema_rampup)
    return 0.5 ** (batch_size / max(ema_nimg, 1e-8))


class TrainState:
    """G, D, G_ema and the two Adams, with the step count."""

    def __init__(self, G: Generator, D: Discriminator):
        self.G, self.D = G.train(), D.train()
        self.G_ema = copy.deepcopy(G).eval().requires_grad_(False)
        for module in (G, D):
            frozen = {id(p) for p in module.parameters()} - {id(p) for _, p in trainable(module)}
            for p in module.parameters():
                p.requires_grad_(id(p) not in frozen)
        self.params_g = [p for _, p in trainable(G)]
        self.params_d = [p for _, p in trainable(D)]
        self.opt_g = Adam(self.params_g, G_REG_INTERVAL)
        self.opt_d = Adam(self.params_d, D_REG_INTERVAL)
        self.step = 0


def _grads(total: torch.Tensor, params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """d total / d params, zeros for a parameter that takes no part, NaN
    and inf replaced (StyleGAN2 training_loop.py:309)."""
    grads = torch.autograd.grad(total, params, allow_unused=True)
    out = []
    for p, g in zip(params, grads):
        g = torch.zeros_like(p) if g is None else g
        out.append(torch.nan_to_num(g, nan=0.0, posinf=1e5, neginf=-1e5))
    return out


def train_step(state: TrainState, batch: Dict[str, torch.Tensor], generator: torch.Generator,
               batch_size: int = 16, weights: LossWeights = LossWeights(),
               deterministic: bool = False) -> dict:
    """One main step; returns each phase's loss terms (``stats``) and
    gradients as Adam took them (``grads_g``, ``grads_d``). ``deterministic``
    turns dropout off (the benchmark's count of operations, on the meta
    device)."""
    cfg = state.G.cfg
    dev = batch["labels"].device
    b = batch["labels"].shape[0]
    text_feat = make_text_feature_fn(state.G.text_encoder)(
        batch["text_ids"], batch["text_mask"], deterministic, generator)
    batch = dict(batch, text_feat_g=text_feat, text_feat_d=text_feat)

    def draw_z():
        gen = None if deterministic else fork_generator(generator, dev)
        return torch.randn(b, cfg.max_elements, cfg.z_dim, device=dev, generator=gen)

    z_g = draw_z()
    total_g, stats_g = g_main_loss(state.G, state.D, batch, z_g, weights, deterministic, generator)
    grads_g = _grads(total_g, state.params_g)
    state.opt_g.step(grads_g)

    z_d = draw_z()
    total_d, stats_d = d_main_loss(state.G, state.D, batch, z_d, weights, deterministic, generator)
    grads_d = _grads(total_d, state.params_d)
    state.opt_d.step(grads_d)

    ema_kimg = batch_size * 10 / 32
    beta = ema_beta(batch_size, ema_kimg, (state.step + 1) * batch_size)
    with torch.no_grad():
        for e, p in zip(state.G_ema.parameters(), state.G.parameters()):
            if p.requires_grad:
                e.copy_((e - p) * beta + p)
    state.step += 1
    stats = {k: v.detach() for k, v in {**stats_g, **stats_d}.items()}
    return dict(stats=stats, grads_g=grads_g, grads_d=grads_d)
