"""What one step or one batch asks of the card, counted on the meta device
from the benchmark's plain reference at the cell's shapes: the FLOPs of its
matrix products and convolutions (``torch.utils.flop_counter``), and the
shapes of the calls that the program makes through its hand-written
kernels (the frozen text encoder's self-attention, the StyleGAN2 layers'
bias + activation, each with or without a backward).

Nothing here runs on the card or reads the program: a later change to the
program cannot change these counts.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import bert, stylegan2
from benchmark.reference.config import GeneratorConfig
from benchmark.reference.generator import Generator
from benchmark.reference.train_step import TrainState, make_models, train_step


@dataclasses.dataclass
class Census:
    flops: float  # matmul and conv FLOPs of one step or batch
    attention: List[dict]  # one per fused-attention call: shape, dtype, dropout
    bias_act: List[dict]  # one per bias_act call: shape, dim, act, gain, clamp, backward


@contextlib.contextmanager
def _recorded(attention_calls: list, bias_act_calls: list, dropout: bool):
    real_attention, real_bias_act = bert.attention, stylegan2.bias_act

    def attention(q, k, v, bias, scale, dropout_rate=0.0, seed=None):
        attention_calls.append(dict(shape=tuple(q.shape), itemsize=q.element_size(),
                                    dropout=dropout))
        return real_attention(q, k, v, bias, scale, 0.0, None)

    def bias_act(x, b=None, dim=1, act="linear", alpha=None, gain=None, clamp=None):
        needs_grad = torch.is_grad_enabled() and (
            x.requires_grad or (b is not None and b.requires_grad))
        bias_act_calls.append(dict(shape=tuple(x.shape), itemsize=x.element_size(), dim=dim,
                                   act=act, gain=gain, clamp=clamp, backward=needs_grad))
        return real_bias_act(x, b, dim, act, alpha, gain, clamp)

    bert.attention, stylegan2.bias_act = attention, bias_act
    try:
        yield
    finally:
        bert.attention, stylegan2.bias_act = real_attention, real_bias_act


def meta_batch(cfg: GeneratorConfig, batch: int, text_len: int) -> dict:
    n, s = cfg.max_elements, cfg.background_size
    with torch.device("meta"):
        return dict(labels=torch.empty(batch, n, dtype=torch.long),
                    bboxes=torch.empty(batch, n, 4),
                    text_ids=torch.empty(batch, n, text_len, dtype=torch.long),
                    text_mask=torch.empty(batch, n, text_len, dtype=torch.int32),
                    text_len=torch.empty(batch, n, dtype=torch.long),
                    mask=torch.empty(batch, n, dtype=torch.bool),
                    background=torch.empty(batch, s, s, 3))


def train_step_census(cfg: GeneratorConfig, batch: int) -> Census:
    """One main train step at ``batch`` samples of ``cfg.max_text_length``
    tokens. Dropout is off on the meta device; it changes no product's
    shape, and the attention calls are those of the dropout form."""
    G, D = make_models(cfg, 0, "meta")
    state = TrainState(G, D)
    data = meta_batch(cfg, batch, cfg.max_text_length)
    attention_calls, bias_act_calls = [], []
    with _recorded(attention_calls, bias_act_calls, dropout=True), \
            FlopCounterMode(display=False) as counter:
        train_step(state, data, torch.Generator(), batch_size=batch, deterministic=True)
    return Census(float(counter.get_total_flops()), attention_calls, bias_act_calls)


def generate_census(cfg: GeneratorConfig, batch: int) -> Census:
    """One batch of ``batch`` requests through G's forward, eval and
    deterministic, without gradients."""
    with torch.device("meta"):
        G = Generator(cfg).eval().requires_grad_(False)
    data = meta_batch(cfg, batch, cfg.max_text_length)
    with torch.device("meta"):
        z = torch.empty(batch, cfg.max_elements, cfg.z_dim)
    attention_calls, bias_act_calls = [], []
    with _recorded(attention_calls, bias_act_calls, dropout=False), \
            FlopCounterMode(display=False) as counter, torch.inference_mode():
        G(z, data["labels"], None, data["text_ids"], data["text_mask"], data["text_len"],
          ~data["mask"], data["background"])
    return Census(float(counter.get_total_flops()), attention_calls, bias_act_calls)
