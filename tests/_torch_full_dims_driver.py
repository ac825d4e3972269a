"""The port against the JAX package at production dims, both on the CPU.

The port's CPU tests hold every module to the JAX package at tiny widths
(1e-5). This driver holds it at the reference's production training
config, where 768-wide softmax ranges, LayerNorm eps and the drift through
~50 layers show, to the bar of ``docs/PARITY.md:127``: max-abs ≤ 1e-3 for
every output, ≤ 2e-3 for ``bg_rec``. The config is that of
``tests/_full_dims_driver.py:47-51``:

    B=1, 9 elements, T=256 (token lengths 2..256, max-length sequences
    included), BERT 768 wide with 12 encoder + 2 decoder layers, 4 heads,
    intermediate 3072, vocab 30524, hidden 256, DETR 6+6 (8 heads, FFN
    2048), im_f_dim 512, 256^2 background, fp32, deterministic.

Weights are random JAX params from a seed, crossed over to the port with
``generator_state_dict_from_jax`` / ``discriminator_state_dict_from_jax``.
Compared outputs (``docs/PARITY.md:116-125``): G at ``reconst=True``
(``bbox_fake``, ``logit_cls`` of the valid elements, ``loss_z``,
``loss_lm``, ``loss_text_len``), D at ``reconst=True`` (both critics'
logits, ``bbox_rec`` and ``logit_cls`` of both decoders at the valid
elements, ``loss_lm``, ``loss_text_len``, ``bg_rec``), and the stats of one
deterministic train step (shared hoisted text pass, the same z on both
sides). Then the same G and D forwards with ``backbone='vit'`` (ViT-B/16
at 256^2, a 16 x 16 DETR memory), and the LayoutGAN++ pair at
``LayoutGanPPConfig()`` defaults (T=40, background 256; G's boxes, D's
logit, ``bbox_pred`` of the valid elements, ``loss_lm`` and ``bg_rec`` at
``reconst=True``). Last, a JAX train state carried into the port
(``compare_orbax``): the JAX ``GANTrainState`` of these G and D after one
optax update from seeded gradients, saved with JAX's ``save_checkpoint``
and converted by ``tools/orbax_to_port.py``; the port's
``restore_checkpoint`` takes it strictly, G, D and G_ema hold the
converters' bits, the Adam entries are those of a port step's, one more
update agrees with optax to 1e-6 of each tensor's max |value|, and G_ema's
boxes (from the snapshot and from ``--generator-only``) match JAX's
``load_generator_checkpoint`` to the 1e-3 bar.

Run standalone (not collected by the test suite; about 4 minutes on an
8-core Xeon for the LayoutDETR models with the train step, most of it
XLA compiling JAX's train step; the orbax case writes two ~5 GB files to
a temporary directory):

    python tests/_torch_full_dims_driver.py [--no-step] [--models detr,vit,layoutganpp,orbax]

``tests/test_torch_full_dims_driver.py`` runs every case at tiny dims.
The card's half is transitive: ``chip_smoke.py`` holds the port on the
card against the port on the CPU at full width.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import hashlib
import json
import os
import platform
import sys
import tempfile
import time

import numpy as np

import conftest  # noqa: F401  (forces JAX to the CPU, offline guards, sys.path)

import jax
import jax.numpy as jnp
import optax
import torch

from layoutdetr_tpu.models.discriminator import Discriminator as JaxDiscriminator
from layoutdetr_tpu.models.generator import Generator as JaxGenerator
from layoutdetr_tpu.models.generator import GeneratorConfig as JaxConfig
from layoutdetr_tpu.models.generator import make_text_feature_fn as jax_text_feature_fn
from layoutdetr_tpu.models.layoutganpp import LayoutGanPPConfig as JaxLGPPConfig
from layoutdetr_tpu.models.layoutganpp import LayoutGanPPDiscriminator as JaxLGPPD
from layoutdetr_tpu.models.layoutganpp import LayoutGanPPGenerator as JaxLGPPG
from layoutdetr_tpu.training import optimizers as jax_opt
from layoutdetr_tpu.training import train_step as jax_step
from layoutdetr_tpu.utils import checkpoint as jax_ckpt
from layoutdetr_tpu_torch.config import GeneratorConfig
from layoutdetr_tpu_torch.models.discriminator import Discriminator
from layoutdetr_tpu_torch.models.generator import Generator
from layoutdetr_tpu_torch.models.layoutganpp import (
    LayoutGanPPConfig,
    LayoutGanPPDiscriminator,
    LayoutGanPPGenerator,
)
from layoutdetr_tpu_torch.training.optimizers import build_optimizer
from layoutdetr_tpu_torch.training.train_step import GANTrainState, make_train_step
from layoutdetr_tpu_torch.utils import checkpoint as ckpt
from layoutdetr_tpu_torch.utils.convert import (
    discriminator_state_dict_from_jax,
    generator_state_dict_from_jax,
    layoutganpp_discriminator_state_dict_from_jax,
    layoutganpp_generator_state_dict_from_jax,
)

from test_torch_common import REPO_ROOT, random_params

sys.path.insert(0, os.path.join(REPO_ROOT, "tools"))
import orbax_to_port  # noqa: E402

FULL = dict(
    z_dim=4, num_bbox_labels=8, max_elements=9, hidden_dim=256, bert_f_dim=768,
    bert_num_heads=4, bert_num_encoder_layers=12, bert_num_decoder_layers=2,
    bert_intermediate_size=3072, bert_max_position_embeddings=512, im_f_dim=512,
    max_text_length=256, vocab_size=30524, bos_token_id=30522, pad_token_id=0, nhead=8,
    num_encoder_layers=6, num_decoder_layers=6, dim_feedforward=2048, background_size=256,
)
BAR, BG_REC_BAR = 1e-3, 2e-3  # docs/PARITY.md:127
LENGTHS = (64, 4, 256, 192, 3, 33, 2, 2, 2)  # tokens per element, [CLS] included
N_VALID = 6  # elements 6..8 are padding
G_NAMES = ("bbox_fake", "loss_z", "logit_cls", "loss_lm", "loss_text_len")
D_NAMES = ("logit", "logit_uncond", "bbox_rec", "logit_cls", "loss_lm", "loss_text_len",
           "bg_rec", "bbox_rec_uncond", "logit_cls_uncond")
LGPP_D_NAMES = ("logit", "bbox_pred", "loss_lm", "bg_rec")
PER_ELEMENT = ("logit_cls", "bbox_rec", "bbox_rec_uncond", "logit_cls_uncond", "bbox_pred")
MODELS = ("detr", "vit", "layoutganpp", "orbax")
GLR, DLR = 2e-5, 3e-5  # a JAX run's learning rates, in its training_options.json
PL_MEAN = 0.375


def make_inputs(cfg: JaxConfig, seed: int = 3) -> dict:
    """B=1, the model's inputs (numpy, background channels last)."""
    rng = np.random.default_rng(seed)
    n, t = cfg.max_elements, cfg.max_text_length
    # BERT's [CLS] and word ids; a tiny test vocab takes ids below its size
    cls, lo, hi = (101, 1000, 29000) if cfg.vocab_size > 29000 else (1, 2, cfg.vocab_size - 2)
    ids = np.zeros((1, n, t), np.int64)
    mask = np.zeros((1, n, t), np.int32)
    for i, length in enumerate(LENGTHS[:n]):
        length = min(length, t)
        ids[0, i, 0] = cls
        ids[0, i, 1:length] = rng.integers(lo, hi, size=length - 1)
        mask[0, i, :length] = 1
    pad = np.arange(n)[None] >= N_VALID
    return dict(
        z=rng.normal(size=(1, n, cfg.z_dim)).astype(np.float32),
        bbox_class=rng.integers(0, cfg.num_bbox_labels, size=(1, n)),
        bbox=rng.uniform(0.1, 0.9, size=(1, n, 4)).astype(np.float32),
        text_ids=ids, text_mask=mask,
        text_len=rng.integers(0, cfg.text_len_table, size=(1, n)),
        padding_mask=pad,
        background=rng.normal(size=(1, cfg.background_size, cfg.background_size, 3))
        .astype(np.float32),
    )


def _model_kwargs(x: dict) -> dict:
    return {k: x[k] for k in ("bbox_class", "text_ids", "text_mask", "text_len", "padding_mask",
                              "background")}


def _step_batch(x: dict) -> dict:
    return dict(bboxes=x["bbox"], labels=x["bbox_class"], text_ids=x["text_ids"],
                text_mask=x["text_mask"], text_len=x["text_len"], mask=~x["padding_mask"],
                background=x["background"])


def _torch(tree: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _jax_z(rng, n: int, z_dim: int):
    """The z JAX's step draws for one phase at B=1 (train_step.py:171-194)."""
    rng, _ = jax.random.split(rng)  # the text-pass split
    rng_z, _ = jax.random.split(rng)
    return np.array(jax.random.normal(rng_z, (1, n, z_dim)))


def _row(name: str, got, want, bar: float = BAR) -> dict:
    got = np.asarray(got.detach().float().numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} vs {want.shape}")
    d = np.abs(got - want)
    return dict(name=name, max_abs=float(d.max()), scale=float(np.abs(want).max()), bar=bar,
                ok=bool(d.max() <= bar))


def _outputs(prefix: str, names, got, want, valid) -> list:
    rows = []
    for name, g, w in zip(names, got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        if name in PER_ELEMENT:
            g, w, name = g[valid], w[valid], f"{name}[valid]"
        rows.append(_row(f"{prefix} {name}", g, w, BG_REC_BAR if name == "bg_rec" else BAR))
    return rows


def compare(dims: dict, seed: int = 0, step: bool = True, log=print) -> list:
    """The port vs JAX on one B=1 input at ``dims`` (GeneratorConfig
    fields), random JAX params from ``seed``: one row per compared output,
    ``dict(name, max_abs, scale, bar, ok)``."""
    jcfg = JaxConfig(**dims)
    cfg = GeneratorConfig.from_dict(dims)
    x = make_inputs(jcfg)
    kw = _model_kwargs(x)
    valid = ~x["padding_mask"]
    t0 = time.perf_counter()

    def mark(what):
        log(f"[{time.perf_counter() - t0:7.1f} s] {what}")

    jg, jd = JaxGenerator(jcfg), JaxDiscriminator(jcfg)
    pg = random_params(jg, z=x["z"], bbox_real=x["bbox"], reconst=True, seed=seed, **kw)
    pd = random_params(jd, bbox=x["bbox"], reconst=True, seed=seed + 1, **kw)
    mark("JAX params drawn")
    want_g = jax.tree.map(np.asarray, jax.jit(lambda p: jg.apply(
        {"params": p}, z=x["z"], bbox_real=x["bbox"], reconst=True, **kw))(pg))
    mark("JAX G forward")
    want_d = jax.tree.map(np.asarray, jax.jit(lambda p: jd.apply(
        {"params": p}, bbox=x["bbox"], reconst=True, **kw))(pd))
    mark("JAX D forward")

    want_stats = z = None
    if step:
        batch = _step_batch(x)
        vg, vd = {"params": pg}, {"params": pd}
        tx_g = jax_opt.build_optimizer(vg, reg_interval=4,
                                       frozen_substrings=jax_opt.G_FROZEN_SUBSTRINGS)
        tx_d = jax_opt.build_optimizer(vd, reg_interval=16,
                                       frozen_substrings=jax_opt.D_FROZEN_SUBSTRINGS)
        state = jax_step.GANTrainState.create(vg, vd, tx_g, tx_d)
        fn = jax_step.make_train_step(
            jg.apply, jd.apply, tx_g, tx_d, batch_size=1, z_dim=jcfg.z_dim,
            max_elements=jcfg.max_elements, deterministic=True,
            text_feature_fn=jax_text_feature_fn(jcfg, flash=False), share_text_encoder=True,
            ema_freeze_labels=jax_opt.freeze_mask(vg, jax_opt.G_FROZEN_SUBSTRINGS))
        rng = jax.random.PRNGKey(1)
        state, stats = jax.jit(fn, donate_argnums=(0,))(state, batch, rng)
        want_stats = {k: float(v) for k, v in stats.items()}
        del state, stats, fn
        gc.collect()
        rng_g, rng_d = jax.random.split(rng)
        z = tuple(torch.from_numpy(_jax_z(r, jcfg.max_elements, jcfg.z_dim))
                  for r in (rng_g, rng_d))
        mark("JAX train step")

    G, D = Generator(cfg), Discriminator(cfg)
    G.load_state_dict(generator_state_dict_from_jax(pg, cfg), strict=True)
    D.load_state_dict(discriminator_state_dict_from_jax(pd, cfg), strict=True)
    del pg, pd
    tkw = _torch(kw)
    with torch.no_grad():
        got_g = G.eval()(z=torch.from_numpy(x["z"]), bbox_real=None, reconst=True, **tkw)
        mark("port G forward")
        got_d = D.eval()(bbox=torch.from_numpy(x["bbox"]), reconst=True, **tkw)
        mark("port D forward")
    rows = _outputs("G", G_NAMES, got_g, want_g, valid)
    rows += _outputs("D", D_NAMES, got_d, want_d, valid)

    if step:
        state = GANTrainState.create(G.train(), D.train(), build_optimizer(G, reg_interval=4),
                                     build_optimizer(D, reg_interval=16))
        got_stats = make_train_step(batch_size=1, z_dim=cfg.z_dim, max_elements=cfg.max_elements,
                                    deterministic=True)(state, _torch(_step_batch(x)),
                                                        torch.Generator().manual_seed(0), z=z)
        mark("port train step")
        if set(got_stats) != set(want_stats):
            raise AssertionError(f"step stats {sorted(got_stats)} vs {sorted(want_stats)}")
        rows += [_row(f"step {k}", float(got_stats[k]), v) for k, v in sorted(want_stats.items())]
    return rows


def compare_layoutganpp(dims: dict, seed: int = 0, log=print) -> list:
    """The LayoutGAN++ G and D (``reconst=True``) vs JAX on one B=1 input at
    ``dims`` (``LayoutGanPPConfig`` fields), random JAX params from
    ``seed``; rows as ``compare``'s, named ``layoutganpp G ...``/``D ...``."""
    jcfg = JaxLGPPConfig(**dims)
    cfg = LayoutGanPPConfig.from_dict(dataclasses.asdict(jcfg))
    x = make_inputs(jcfg)
    kw = _model_kwargs(x)
    t0 = time.perf_counter()
    jg, jd = JaxLGPPG(jcfg), JaxLGPPD(jcfg)
    pg = random_params(jg, z=x["z"], bbox_real=x["bbox"], seed=seed, **kw)
    pd = random_params(jd, bbox=x["bbox"], reconst=True, seed=seed + 1, **kw)
    want_g = np.asarray(jax.jit(lambda p: jg.apply({"params": p}, z=x["z"], bbox_real=x["bbox"],
                                                   **kw))(pg))
    want_d = jax.tree.map(np.asarray, jax.jit(lambda p: jd.apply(
        {"params": p}, bbox=x["bbox"], reconst=True, **kw))(pd))
    log(f"[{time.perf_counter() - t0:7.1f} s] JAX LayoutGAN++ G and D forwards")
    G, D = LayoutGanPPGenerator(cfg), LayoutGanPPDiscriminator(cfg)
    G.load_state_dict(layoutganpp_generator_state_dict_from_jax(pg, cfg), strict=True)
    D.load_state_dict(layoutganpp_discriminator_state_dict_from_jax(pd, cfg), strict=True)
    tkw = _torch(kw)
    with torch.no_grad():
        got_g = G.eval()(z=torch.from_numpy(x["z"]), bbox_real=None, **tkw)
        got_d = D.eval()(bbox=torch.from_numpy(x["bbox"]), reconst=True, **tkw)
    log(f"[{time.perf_counter() - t0:7.1f} s] port LayoutGAN++ G and D forwards")
    valid = ~x["padding_mask"]
    return (_outputs("layoutganpp G", ("bbox_fake",), (got_g,), (want_g,), valid)
            + _outputs("layoutganpp D", LGPP_D_NAMES, got_d, want_d, valid))


def seeded_grads(tree, seed: int):
    """Seeded gradients in the layout of the JAX param tree ``tree`` (arrays
    or shapes); zero on the FrozenBN statistics, which JAX's modules stop
    the gradient at (the port holds them as buffers)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        g = rng.normal(scale=0.01, size=np.shape(x)).astype(np.float32)
        parent = str(getattr(path[-2], "key", "")) if len(path) > 1 else ""
        return 0 * g if parent.startswith("bn") or parent == "downsample_bn" else g

    return jax.tree_util.tree_map_with_path(leaf, tree)


def jax_train_state(pg: dict, pd: dict, glr: float = GLR, dlr: float = DLR):
    """The JAX ``GANTrainState`` of G and D params ``pg``, ``pd`` after one
    optax update of each from seeded gradients (non-zero moments, count
    1); G_ema keeps the initial G. Returns ``(state, tx_g, tx_d)``."""
    vg, vd = {"params": pg}, {"params": pd}
    tx_g = jax_opt.build_optimizer(vg, lr=glr, reg_interval=4,
                                   frozen_substrings=jax_opt.G_FROZEN_SUBSTRINGS)
    tx_d = jax_opt.build_optimizer(vd, lr=dlr, reg_interval=16,
                                   frozen_substrings=jax_opt.D_FROZEN_SUBSTRINGS)
    state = jax_step.GANTrainState.create(vg, vd, tx_g, tx_d)
    ug, og = jax.jit(tx_g.update)(seeded_grads(vg, 11), state.opt_state_g, vg)
    ud, od = jax.jit(tx_d.update)(seeded_grads(vd, 12), state.opt_state_d, vd)
    state = state.replace(params_g=optax.apply_updates(vg, ug), params_d=optax.apply_updates(vd, ud),
                          opt_state_g=og, opt_state_d=od, pl_mean=jnp.float32(PL_MEAN),
                          step=jnp.int32(1))
    return state, tx_g, tx_d


def save_jax_run(state, jcfg: JaxConfig, run_dir: str, batch_size: int, glr: float = GLR,
                 dlr: float = DLR) -> str:
    """The JAX trainer's files in ``run_dir``: the orbax snapshot (JAX's
    ``save_checkpoint``), its ``.gcfg.json`` and the run's
    ``training_options.json``; returns the snapshot's path."""
    os.makedirs(run_dir, exist_ok=True)
    src = os.path.join(run_dir, "network-snapshot-000000")
    jax_ckpt.save_checkpoint(src, state)
    with open(src + ".gcfg.json", "w") as f:
        json.dump(dataclasses.asdict(jcfg), f)
    with open(os.path.join(run_dir, "training_options.json"), "w") as f:
        json.dump({"glr": glr, "dlr": dlr, "batch_size": batch_size}, f)
    return src


def port_train_state(cfg: GeneratorConfig, glr: float = GLR, dlr: float = DLR) -> GANTrainState:
    """A fresh port state (seeded weights) for ``restore_checkpoint``."""
    torch.manual_seed(5)
    G, D = Generator(cfg), Discriminator(cfg)
    return GANTrainState.create(G.train(), D.train(), build_optimizer(G, lr=glr, reg_interval=4),
                                build_optimizer(D, lr=dlr, reg_interval=16))


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _bits(sd: dict) -> dict:
    """Each tensor's dtype, shape and a digest of its bytes."""
    return {k: (str(v.dtype), tuple(v.shape),
                hashlib.sha256(v.detach().contiguous().reshape(-1).view(torch.uint8).numpy())
                .hexdigest()) for k, v in sd.items()}


def _adam_layout(opt: torch.optim.Optimizer) -> dict:
    """An Adam state dict's groups and each entry's keys, shapes and dtypes."""
    sd = opt.state_dict()
    return dict(groups=sd["param_groups"],
                state={i: {k: (tuple(v.shape), v.dtype) for k, v in e.items()}
                       for i, e in sd["state"].items()})


def _count_row(name: str, bad: int, of: int) -> dict:
    return dict(name=f"{name} (of {of})", max_abs=float(bad), scale=float(of), bar=0.0,
                ok=bad == 0)


def compare_orbax(dims: dict, seed: int = 0, log=print) -> list:
    """A JAX train state at ``dims`` (GeneratorConfig fields) into the port
    through ``tools/orbax_to_port.py``, random JAX params from ``seed``; rows
    as ``compare``'s, named ``orbax ...``: the count of G's, D's and
    G_ema's tensors off the converters' bits and of Adam entries unlike a
    port step's (bar 0), the next update against optax (the worst error
    over a tensor's max |value|, bar 1e-6), and G_ema's boxes against
    JAX's ``load_generator_checkpoint`` from the converted snapshot and
    from the ``--generator-only`` file."""
    jcfg = JaxConfig(**dims)
    cfg = GeneratorConfig.from_dict(dims)
    x = make_inputs(jcfg)
    kw = _model_kwargs(x)
    t0 = time.perf_counter()

    def mark(what):
        log(f"[{time.perf_counter() - t0:7.1f} s] {what}")

    jg = JaxGenerator(jcfg)
    pg = random_params(jg, z=x["z"], bbox_real=x["bbox"], reconst=True, seed=seed, **kw)
    pd = random_params(JaxDiscriminator(jcfg), bbox=x["bbox"], reconst=True, seed=seed + 1, **kw)
    state, tx_g, tx_d = jax_train_state(pg, pd)
    del pg, pd
    mark("JAX train state after one optax update")
    to_sd = dict(G=generator_state_dict_from_jax, D=discriminator_state_dict_from_jax)
    rows = []
    with tempfile.TemporaryDirectory(prefix="orbax_to_port_") as tmp:
        src = save_jax_run(state, jcfg, os.path.join(tmp, "run"), batch_size=1)
        mark("saved with JAX's save_checkpoint")
        # JAX's side, kept small before the port's: the converters' bits, the
        # next update from seeded gradients, G_ema's boxes through JAX's reader
        bits, want, shapes = {}, {}, {}
        for key, params in (("G", state.params_g), ("D", state.params_d),
                            ("G_ema", state.params_gema)):
            bits[key] = _bits(to_sd[key[0]](_np(params), cfg))
        for key, params, opt_state, tx in (("G", state.params_g, state.opt_state_g, tx_g),
                                           ("D", state.params_d, state.opt_state_d, tx_d)):
            updates, _ = jax.jit(tx.update)(seeded_grads(params, 21), opt_state, params)
            want[key] = to_sd[key](_np(optax.apply_updates(params, updates)), cfg)
            shapes[key] = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), params)
            del updates
        del state
        gc.collect()
        box_kw = dict(z=x["z"], bbox_real=x["bbox"], **kw)
        params, gema_cfg = jax_ckpt.load_generator_checkpoint(src)
        want_boxes = np.asarray(jax.jit(JaxGenerator(gema_cfg).apply)(params, **box_kw))
        del params
        gc.collect()
        mark("JAX's next update and G_ema's boxes")

        dest, g_file = os.path.join(tmp, "snapshot.pt"), os.path.join(tmp, "g.pt")
        what = orbax_to_port.convert_checkpoint(src, dest)
        if "training snapshot (step 1)" not in what:
            raise AssertionError(f"orbax_to_port wrote {what}")
        orbax_to_port.convert_checkpoint(src, g_file, generator_only=True)
        mark("converted by tools/orbax_to_port.py (snapshot and --generator-only)")

        pstate = ckpt.restore_checkpoint(dest, port_train_state(cfg))  # strict
        if pstate.step != 1 or float(pstate.pl_mean) != PL_MEAN:
            raise AssertionError(f"step {pstate.step}, pl_mean {float(pstate.pl_mean)}")
        for key in ("G", "D", "G_ema"):
            got = _bits(getattr(pstate, key).state_dict())
            if got.keys() != bits[key].keys():
                raise AssertionError(f"{key}: state dict keys differ from the converter's")
            rows.append(_count_row(f"orbax {key} tensors off the converter's bits",
                                   sum(got[k] != v for k, v in bits[key].items()), len(got)))
        restored = dict(opt_g=_adam_layout(pstate.opt_g), opt_d=_adam_layout(pstate.opt_d))
        for key, model, opt in (("G", pstate.G, pstate.opt_g), ("D", pstate.D, pstate.opt_d)):
            for e in opt.state.values():
                if float(e["step"]) != 1.0 or not e["exp_avg_sq"].abs().max() > 0:
                    raise AssertionError(f"{key}: an Adam entry is not one update old")
            grads = to_sd[key](seeded_grads(shapes[key], 21), cfg)
            n_stepped = 0
            for name, p in model.named_parameters():
                if p in opt.state:  # a JAX leaf's parameter (not a filled cross-attention block)
                    p.grad = grads[name]
                    n_stepped += 1
            opt.step()
            got = model.state_dict()
            worst = max(float((got[n] - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                        for n, w in want[key].items())
            rows.append(dict(name=f"orbax next update {key}, error over max abs w "
                                  f"({n_stepped} stepped)",
                             max_abs=worst, scale=1.0, bar=1e-6, ok=worst <= 1e-6))
            del grads
        del pstate, want
        gc.collect()
        mark("port restore, bits and the next update")

        fresh = port_train_state(cfg)
        make_train_step(batch_size=1, z_dim=cfg.z_dim, max_elements=cfg.max_elements,
                        deterministic=True)(fresh, _torch(_step_batch(x)),
                                            torch.Generator().manual_seed(0))
        for key in ("opt_g", "opt_d"):
            mine, theirs = restored[key], _adam_layout(getattr(fresh, key))
            if mine["groups"] != theirs["groups"] or mine["state"].keys() != theirs["state"].keys():
                raise AssertionError(f"{key}: groups or entries differ from a port step's")
            rows.append(_count_row(f"orbax {key} entries unlike a port step's",
                                   sum(mine["state"][i] != e for i, e in theirs["state"].items()),
                                   len(theirs["state"])))
        del fresh
        gc.collect()
        mark("a port step's Adam entries")

        tkw = _torch(box_kw)
        for path, label in ((dest, "snapshot"), (g_file, "--generator-only")):
            model = ckpt.load_generator_checkpoint(path, device="cpu")
            if _bits(model.state_dict()) != bits["G_ema"]:
                raise AssertionError(f"{label}: G_ema is not the converter's")
            with torch.inference_mode():
                got = model(**tkw)
            rows.append(_row(f"orbax G_ema boxes ({label})", got, want_boxes))
            del model
        mark("the port's G_ema boxes")
    return rows


def compare_models(models, dims: dict, lgpp_dims: dict, seed: int = 0, step: bool = True,
                   log=print) -> list:
    """``compare`` for each of ``models``: 'detr' (the LayoutDETR G and D
    at ``dims``, with the train step unless ``step`` is off), 'vit' (their
    forwards with ``backbone='vit'``, rows prefixed ``vit``) and
    'layoutganpp' (``compare_layoutganpp`` at ``lgpp_dims``) and 'orbax'
    (``compare_orbax`` at ``dims``)."""
    rows = []
    if "detr" in models:
        rows += compare(dims, seed, step=step, log=log)
    if "vit" in models:
        rows += [dict(r, name=f"vit {r['name']}")
                 for r in compare(dict(dims, backbone="vit"), seed, step=False, log=log)]
    if "layoutganpp" in models:
        rows += compare_layoutganpp(lgpp_dims, seed, log=log)
    if "orbax" in models:
        rows += compare_orbax(dims, seed, log=log)
    return rows


def table(rows: list) -> str:
    lines = ["| output | max-abs | scale (max \\|JAX\\|) | bar |", "|---|---|---|---|"]
    lines += [f"| {r['name']} | {r['max_abs']:.2e} | {r['scale']:.3g} | {r['bar']:.0e}"
              f"{'' if r['ok'] else ' FAILED'} |" for r in rows]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-step", action="store_true", help="compare the forwards only")
    ap.add_argument("--models", default=",".join(MODELS),
                    help=f"comma-separated subset of {','.join(MODELS)}")
    args = ap.parse_args(argv)
    torch.set_num_threads(os.cpu_count() or 1)
    print(f"host: {platform.processor() or platform.machine()}, {os.cpu_count()} CPUs; "
          f"torch {torch.__version__}, jax {jax.__version__}", flush=True)
    t0 = time.perf_counter()
    models = args.models.split(",")
    if not set(models) <= set(MODELS):
        ap.error(f"--models takes {','.join(MODELS)}")
    rows = compare_models(models, FULL, {}, args.seed, step=not args.no_step,
                          log=lambda s: print(s, flush=True))
    print(table(rows))
    bad = [r["name"] for r in rows if not r["ok"]]
    print(f"{len(rows) - len(bad)} of {len(rows)} outputs within their bars; "
          f"{time.perf_counter() - t0:.0f} s", flush=True)
    if bad:
        print(f"FAILED: {bad}", flush=True)
        return 1
    print("TORCH_FULL_DIMS_PARITY OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
