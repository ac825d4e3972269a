"""The training run: data feed, main and reg steps, ADA, ticks, snapshots.

Counterpart of ``layoutdetr_tpu/training/train_loop.py:178-650``
(reference training_loop.py:63-469), with its control flow:

- the dataset, the sampler and the feed: the dataset resident on the card
  (``data.device_cache``, indices per step) when it fits, else the host
  loader (warm sample cache, a prefetch thread or forked workers, a
  pinned non-blocking copy per batch);
- init from ``random_seed``, ``--init-g``/``--init-d`` grafted onto it,
  G's frozen text encoder copied into D unless ``--init-d`` is given,
  resume, and the check whether G's and D's encoders are equal (then the
  step runs one shared text pass);
- per batch the main step, the path-length step every ``g_reg_interval``
  batches (when ``pl_weight`` > 0) and R1 every ``d_reg_interval`` (when
  ``r1_gamma`` > 0);
- ADA: ``aug_p`` rides in the batch; the controller moves it every
  ``ada.interval`` batches from the mean sign of D's real logits;
- ticks every ``kimg_per_tick``: the status line, ``stats.jsonl``,
  TensorBoard scalars, G_ema layout previews and network snapshots
  (``network-snapshot-<kimg>.pt`` with ``.gcfg.json`` beside it), then
  ``metrics_fn`` on every ``metric_ticks``-th snapshot (the tick's
  maintenance, outside the sec/kimg clock);
- ``abort_fn`` (the CLI's SIGTERM) ends the run after the tick's
  snapshot; ``max_steps`` caps the steps; a resumed run turns the EMA
  ramp-up off and caps ``ada_kimg`` at 100 (reference train.py:290-292).

The steps' stats stay on the card: each step's 0-dim stats are stacked
into one vector, and the vectors of ``stats_fetch_every`` steps come back
in one copy (the ADA interval, else 16; and at every tick). The step time
of the main and the reg steps between two ticks, the stream span between
CUDA events recorded before and after each step (the host clock on the
CPU), is written to ``stats.jsonl`` as ``main_step_s`` and
``reg_step_s``. On a host-bound step that span is mostly the card
waiting on the host, not the card's busy time.
"""

from __future__ import annotations

import os
import resource
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from layoutdetr_tpu_torch.config import GeneratorConfig
from layoutdetr_tpu_torch.data.dataset import (
    InfiniteSampler,
    LayoutDataset,
    PrefetchLoader,
    denormalize_image,
    to_device,
)
from layoutdetr_tpu_torch.data.device_cache import DeviceDatasetCache, gather_batch, should_enable
from layoutdetr_tpu_torch.models.discriminator import Discriminator
from layoutdetr_tpu_torch.models.generator import Generator
from layoutdetr_tpu_torch.training.augment import AdaController, AugmentConfig
from layoutdetr_tpu_torch.training.loss import LossWeights
from layoutdetr_tpu_torch.training.optimizers import build_optimizer
from layoutdetr_tpu_torch.training.train_step import (
    GANTrainState,
    make_d_reg_step,
    make_g_reg_step,
    make_train_step,
)
from layoutdetr_tpu_torch.utils.checkpoint import (
    graft,
    load_state_dict_file,
    restore_checkpoint,
    save_checkpoint,
    write_gcfg,
)
from layoutdetr_tpu_torch.utils.logging import StatsJsonlWriter, TensorboardWriter
from layoutdetr_tpu_torch.utils.stats import Collector


def _model_kwargs(batch: dict) -> dict:
    return dict(bbox_class=batch["labels"], text_ids=batch["text_ids"],
                text_mask=batch["text_mask"], text_len=batch["text_len"],
                padding_mask=batch["padding_mask"], background=batch["background"])


def _cpu_mem_gb() -> float:
    """Peak RSS of this process in GB (reference status line 'cpumem')."""
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return rss / (2 ** 30 if sys.platform == "darwin" else 2 ** 20)  # bytes on macOS, KB on Linux


def _device_mem_gb(device: torch.device):
    """(allocated, peak allocated) device memory in GB; (0, 0) on the CPU."""
    if device.type != "cuda":
        return 0.0, 0.0
    return torch.cuda.memory_allocated(device) / 2 ** 30, torch.cuda.max_memory_allocated(device) / 2 ** 30


class _StepClock:
    """Step time of the main and reg steps between ticks: on a card the
    stream span between CUDA events recorded before and after each step
    (read at the tick, after a sync; it includes the card waiting on the
    host), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.spans = {"main": [], "reg": []}

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def add(self, kind: str, start, end) -> None:
        self.spans[kind].append((start, end))

    def take(self) -> dict:
        """Seconds of each kind since the last ``take``."""
        if self.cuda:
            torch.cuda.synchronize()
        out = {k: sum((s.elapsed_time(e) / 1e3 if self.cuda else e - s) for s, e in v)
               for k, v in self.spans.items()}
        self.spans = {k: [] for k in self.spans}
        return out


def _save_image_snapshot(run_dir: str, state: GANTrainState, dataset: LayoutDataset, cur_nimg: int,
                         device: torch.device, n_samples: int = 4) -> None:
    """G_ema's layouts for the first samples as bbox overlays
    (reference training_loop.py:372-392 saves fake grids each tick)."""
    import PIL.Image

    from layoutdetr_tpu_torch.serving.postprocess import save_bboxes_with_background

    n = min(n_samples, len(dataset))
    host = dataset.collate(list(range(n)))
    b = to_device(host, device)
    cfg = state.G_ema.cfg
    z = torch.randn(n, cfg.max_elements, cfg.z_dim, generator=torch.Generator().manual_seed(cur_nimg))
    with torch.no_grad():
        bbox_fake = state.G_ema(z.to(device), bbox_real=b["bboxes"], **_model_kwargs(b)).cpu().numpy()
    for k in range(n):
        bg = PIL.Image.fromarray(denormalize_image(host["background"][k]))
        save_bboxes_with_background(bbox_fake[k], host["mask"][k], host["labels"][k], bg,
                                    os.path.join(run_dir, f"fakes{cur_nimg // 1000:06d}_{k}.png"))


def _module_summaries(G, D, dataset: LayoutDataset, device: torch.device) -> None:
    """The startup tables of G and D from one forward each at batch 1
    (reference training_loop.py:149-160)."""
    from layoutdetr_tpu_torch.utils.misc import print_module_summary

    b = to_device(dataset.collate([0]), device)
    z = torch.zeros(1, G.cfg.max_elements, G.cfg.z_dim, device=device)
    print_module_summary(G, z, bbox_real=b["bboxes"], reconst=True, **_model_kwargs(b))
    print_module_summary(D, b["bboxes"], reconst=True, **_model_kwargs(b))


def _fetch_stats(pending: list) -> list:
    """The stats dicts of several steps, in one device-to-host copy. Each
    item is (keys, 1-d tensor of their values)."""
    host = torch.cat([v for _, v in pending]).tolist()
    out, i = [], 0
    for keys, _ in pending:
        out.append(dict(zip(keys, host[i:i + len(keys)])))
        i += len(keys)
    return out


def _text_encoders_equal(G, D) -> bool:
    a, b = G.text_encoder.state_dict(), D.text_encoder.state_dict()
    return a.keys() == b.keys() and all(
        a[k].shape == b[k].shape and torch.equal(a[k], b[k]) for k in a)


def init_models(gcfg: GeneratorConfig, device, dtype: torch.dtype = torch.float32, seed: int = 0):
    """G and D with random weights from ``seed``, built on ``device``."""
    torch.manual_seed(seed)
    with torch.device(device):
        return Generator(gcfg, dtype=dtype), Discriminator(gcfg, dtype=dtype)


def training_loop(
    run_dir: str = ".",
    data: str = "",
    gcfg: GeneratorConfig = GeneratorConfig(),
    loss_weights: LossWeights = LossWeights(),
    batch_size: int = 16,
    batch_gpu: Optional[int] = None,
    glr: float = 1e-5,
    dlr: float = 1e-5,
    g_reg_interval: Optional[int] = 4,
    d_reg_interval: Optional[int] = 16,
    total_kimg: int = 25000,
    kimg_per_tick: int = 4,
    network_snapshot_ticks: Optional[int] = 50,
    image_snapshot_ticks: Optional[int] = 50,
    random_seed: int = 0,
    ema_rampup: Optional[float] = 0.05,
    resume: Optional[str] = None,
    resume_kimg: int = 0,
    init_g: Optional[str] = None,
    init_d: Optional[str] = None,
    abort_fn: Optional[Callable] = None,
    progress_fn: Optional[Callable] = None,
    max_steps: Optional[int] = None,
    module_summary: bool = True,
    dtype: torch.dtype = torch.float32,
    aug: str = "noaug",
    aug_p: float = 0.2,
    ada_target: Optional[float] = None,
    ada_kimg: float = 500.0,
    aug_geom: bool = False,
    num_workers: Optional[int] = None,
    device_feed="auto",
    device="cuda",
    metrics_fn: Optional[Callable] = None,
    metric_ticks: int = 1,
) -> GANTrainState:
    """Run GAN training on ``device``; returns the final state.
    ``metrics_fn(state, snapshot_path, cur_nimg)`` runs after a network
    snapshot, on every ``metric_ticks``-th one and the last."""
    start_time = time.time()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training on cuda, but torch sees no CUDA device (pass device='cpu' "
                           "to train on the CPU)")
    if resume:
        ema_rampup = None
        ada_kimg = min(ada_kimg, 100.0)

    dataset = LayoutDataset(data, background_size=gcfg.background_size,
                            max_text_length=gcfg.max_text_length, text_len_clip=gcfg.text_len_table)
    use_device_feed = should_enable(dataset, device_feed)
    sampler = InfiniteSampler(len(dataset), seed=random_seed)
    if use_device_feed:
        dcache = DeviceDatasetCache(dataset, device)
        sampler_it = iter(sampler)
        feed_desc = f"device feed ({dcache.nbytes / 2 ** 20:.0f} MB on {device})"
    else:
        dataset.warm_cache(verbose=True)
        if num_workers is None:
            cores = os.cpu_count() or 1
            num_workers = min(8, cores) if cores > 1 else 0
        feed_desc = (f"cache {'on' if dataset._cache is not None else 'off'}, "
                     f"{num_workers} prefetch workers")
    print(f"Dataset: {len(dataset)} samples, {dataset.num_bbox_labels} labels ({feed_desc})")

    G, D = init_models(gcfg, device, dtype, random_seed)
    opt_g = build_optimizer(G.train(), lr=glr, reg_interval=g_reg_interval)
    opt_d = build_optimizer(D.train(), lr=dlr, reg_interval=d_reg_interval)
    if module_summary:
        _module_summaries(G, D, dataset, device)
    for path, module, key in ((init_g, G, "G"), (init_d, D, "D")):
        if path:
            # converted reference weights index BERT by real WordPiece ids
            dataset.tokenizer.require_hf_for_checkpoint(path)
            module.load_state_dict(graft(module.state_dict(), load_state_dict_file(path, key)))
            print(f"Initialized {key} from {path}")
    if not init_d:
        # G's and D's frozen encoders start from the same pretrained BERT in
        # the reference (networks_detr.py:92, :226): a fresh init copies G's
        D.text_encoder.load_state_dict(G.text_encoder.state_dict())

    state = GANTrainState.create(G, D, opt_g, opt_d)
    if resume:
        restore_checkpoint(resume, state)
        print(f"Resumed from {resume}")
    share_te = _text_encoders_equal(state.G, state.D)
    print(f"Text-encoder sharing: {'ON (identical frozen weights)' if share_te else 'off'}")

    grad_accum = 1
    if batch_gpu is not None and batch_gpu < batch_size:
        if batch_size % batch_gpu:
            raise ValueError("--batch-gpu must divide the batch")
        grad_accum = batch_size // batch_gpu
    step_fn = make_train_step(loss_weights, batch_size, ema_rampup=ema_rampup, z_dim=gcfg.z_dim,
                              max_elements=gcfg.max_elements, grad_accum=grad_accum,
                              aug_cfg=AugmentConfig() if aug_geom else None,
                              share_text_encoder=share_te)
    g_reg_fn = d_reg_fn = None
    if loss_weights.pl_weight > 0 and g_reg_interval:
        g_reg_fn = make_g_reg_step(loss_weights, gcfg.z_dim, gcfg.max_elements,
                                   gain=float(g_reg_interval))
    if loss_weights.r1_gamma > 0 and d_reg_interval:
        d_reg_fn = make_d_reg_step(loss_weights, gain=float(d_reg_interval))

    loader = None
    if not use_device_feed:
        loader = PrefetchLoader(dataset, batch_size, sampler, num_workers=num_workers)
    collector = Collector()
    jsonl = StatsJsonlWriter(os.path.join(run_dir, "stats.jsonl"))
    tb = TensorboardWriter(run_dir)
    clock = _StepClock(device)
    generator = torch.Generator().manual_seed(random_seed)

    cur_nimg = resume_kimg * 1000
    cur_tick = 0
    tick_start_nimg = cur_nimg
    tick_start_time = time.time()
    maintenance_time = 0.0
    batch_idx = 0
    snap_count = 0

    ada = None
    ada_signs: list = []
    cur_aug_p = 0.0
    if aug == "ada":
        ada = AdaController(target=ada_target or 0.6, kimg=ada_kimg, initial_p=0.0)
        cur_aug_p = ada.p
    elif aug == "fixed":
        cur_aug_p = aug_p
    pending: list = []
    stats_fetch_every = ada.interval if ada is not None else 16

    def drain():
        if not pending:
            return
        for fetched in _fetch_stats(pending):
            collector.report_dict(fetched)
            if ada is not None:
                ada_signs.append(fetched["Loss/signs/real"])
        pending.clear()

    try:
        while True:
            if use_device_feed:
                idx = dcache.put_indices([next(sampler_it) for _ in range(batch_size)])
                batch = gather_batch(dcache.arrays, idx)
            else:
                batch = to_device(next(loader), device)
            if aug != "noaug":
                batch["aug_p"] = cur_aug_p
            t0 = clock.mark()
            stats = step_fn(state, batch, generator)
            clock.add("main", t0, clock.mark())
            for fn, interval in ((g_reg_fn, g_reg_interval), (d_reg_fn, d_reg_interval)):
                if fn is not None and batch_idx % interval == 0:
                    t0 = clock.mark()
                    stats.update(fn(state, batch, generator))
                    clock.add("reg", t0, clock.mark())
            keys = sorted(stats)
            pending.append((keys, torch.stack([stats[k].float() for k in keys])))
            if len(pending) >= stats_fetch_every:
                drain()
            if ada is not None and batch_idx % ada.interval == 0 and ada_signs:
                cur_aug_p = ada.update(batch_idx, batch_size, float(np.mean(ada_signs)))
                ada_signs.clear()
            cur_nimg += batch_size
            batch_idx += 1

            done = cur_nimg >= total_kimg * 1000 or (max_steps is not None and batch_idx >= max_steps)
            if (not done) and cur_tick != 0 and cur_nimg < tick_start_nimg + kimg_per_tick * 1000:
                continue

            # --- tick (reference training_loop.py:341-452) ---
            drain()
            collector.update()
            step_s = clock.take()
            tick_end_time = time.time()
            mem_now, mem_peak = _device_mem_gb(device)
            sec_per_kimg = (tick_end_time - tick_start_time) / max((cur_nimg - tick_start_nimg) / 1e3, 1e-8)
            fields = [f"tick {cur_tick:<5d}", f"kimg {cur_nimg / 1e3:<8.1f}",
                      f"time {tick_end_time - start_time:<12.1f}",
                      f"sec/tick {tick_end_time - tick_start_time:<7.1f}",
                      f"sec/kimg {sec_per_kimg:<7.2f}", f"maintenance {maintenance_time:<6.1f}",
                      f"cpumem {_cpu_mem_gb():<6.2f}", f"mem {mem_now:<6.2f}", f"peak {mem_peak:<6.2f}"]
            extra = {"kimg": cur_nimg / 1e3, "tick": cur_tick, "sec_per_kimg": sec_per_kimg,
                     "maintenance": maintenance_time, "cpumem_gb": _cpu_mem_gb(),
                     "devmem_gb": mem_now, "devmem_peak_gb": mem_peak,
                     "main_step_s": step_s["main"], "reg_step_s": step_s["reg"]}
            if aug != "noaug":
                fields.append(f"augment {cur_aug_p:.3f}")
                extra["augment_p"] = cur_aug_p
            if ada is not None:
                extra["ada_updates"] = ada.updates
            print(" ".join(fields))
            jsonl.write(collector.as_dict(), extra=extra)
            for name in collector.names():
                tb.scalar(name, collector.mean(name), cur_nimg)
            if aug != "noaug":
                tb.scalar("Progress/augment", cur_aug_p, cur_nimg)
            tb.flush()

            if progress_fn is not None:
                progress_fn(cur_nimg // 1000, total_kimg)
            if abort_fn is not None and abort_fn():
                done = True
            if image_snapshot_ticks is not None and (done or cur_tick % image_snapshot_ticks == 0):
                _save_image_snapshot(run_dir, state, dataset, cur_nimg, device)
            if network_snapshot_ticks is not None and (done or cur_tick % network_snapshot_ticks == 0):
                snap_path = os.path.join(run_dir, f"network-snapshot-{cur_nimg // 1000:06d}.pt")
                save_checkpoint(snap_path, state)
                write_gcfg(snap_path, gcfg)
                # synchronous, as the reference's (training_loop.py:413-427),
                # in the tick's maintenance: outside the sec/kimg clock
                if metrics_fn is not None and (done or snap_count % metric_ticks == 0):
                    metrics_fn(state, snap_path, cur_nimg)
                snap_count += 1

            cur_tick += 1
            tick_start_nimg = cur_nimg
            tick_start_time = time.time()
            maintenance_time = tick_start_time - tick_end_time
            if done:
                break
    finally:
        if loader is not None:
            loader.close()
        tb.close()
    print("Training done.")
    return state
