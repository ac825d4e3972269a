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
waiting on the host, not the card's busy time. ``feed_s`` is the host
seconds the loop spent between ticks getting its batches and issuing
their copies to the device (waiting on the loader included). Each line also holds
``launches/<kernel>``, this process's launches of the two kernels so far
(``ops.launch_counts``), which the run prints again at its end. A resume
prints the sha256 of the restored state (``utils.checkpoint.snapshot_digest``),
which equals the snapshot file's.

Several ranks (a grid of ``parallel.distributed``, made by the caller,
e.g. ``train.main --chips N``): the counterpart of JAX's SPMD loop
(train_loop.py:226-255, 446-447, 607-625):

- each data-parallel rank draws its share of the global batch
  (``batch_size // dp_size``; it must divide) from its own sampler stream
  (``InfiniteSampler(rank=dp_rank, num_replicas=dp_size)``), through its
  own device cache or loader on its own card, with its own generator
  (``rank_seed``); the ranks of one model group share all of that;
- G and D start from rank 0's weights (broadcast), then tensor
  parallelism shards them (``tensor_parallel.shard_module_``) and a
  resume restores each rank's slices;
- ADA's p moves by the sign of D's real logits averaged over the ranks,
  so p is one value; ``cur_nimg`` counts the global batch; the
  collector sums every rank's stats at a tick;
- rank 0 alone prints and writes ``stats.jsonl``, TensorBoard, the image
  and network snapshots (with the full tensors of a TP run, see
  ``utils.checkpoint``) and runs the metrics, on a full copy of G_ema
  under TP; before every network snapshot ``check_replica_consistency``
  holds every replicated tensor equal on all ranks;
- SIGTERM on any rank ends the run at the tick on all of them.
"""

from __future__ import annotations

import dataclasses
import json
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
from layoutdetr_tpu_torch.ops import launch_counts
from layoutdetr_tpu_torch.parallel import distributed
from layoutdetr_tpu_torch.parallel import tensor_parallel as tp
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
    snapshot_digest,
    snapshot_of,
    write_gcfg,
)
from layoutdetr_tpu_torch.utils.logging import StatsJsonlWriter, TensorboardWriter
from layoutdetr_tpu_torch.utils.misc import check_replica_consistency
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


def _chief_view(state: GANTrainState) -> GANTrainState:
    """The state rank 0 previews and evaluates: ``state`` itself, or under
    tensor parallelism a copy whose G_ema holds the full tensors (the
    gather is collective: every rank calls this)."""
    shard = tp.model_shard()
    if shard is None:
        return state
    full = tp.gather_state_dict(state.G_ema.state_dict(), *shard, distributed.grid().tp_group)
    if not distributed.grid().is_chief:
        return state
    return dataclasses.replace(state, G_ema=tp.unsharded_copy(state.G_ema, full))


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
    load_patches: bool = False,
) -> GANTrainState:
    """Run GAN training on ``device``; returns the final state (a rank's
    state in a multi-rank run: its slices under tensor parallelism).
    ``batch_size`` is the global batch and ``batch_gpu`` a rank's
    microbatch. ``metrics_fn(state, snapshot_path, cur_nimg)`` runs after
    a network snapshot, on every ``metric_ticks``-th one and the last, on
    rank 0. ``load_patches`` decodes the elements' patches into every
    host batch (they stay on the host: no loss reads them); it needs the
    host loader. With a grid, ``device`` is the grid's."""
    grid = distributed.grid()
    start_time = time.time()
    device = grid.device if grid is not None else torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training on cuda, but torch sees no CUDA device (pass device='cpu' "
                           "to train on the CPU)")
    is_chief = grid is None or grid.is_chief
    dp_rank, dp_size = (grid.dp_rank, grid.dp_size) if grid is not None else (0, 1)
    if batch_size % dp_size:
        raise ValueError(f"batch {batch_size} does not divide over {dp_size} data-parallel ranks")
    local_batch = batch_size // dp_size
    if resume:
        ema_rampup = None
        ada_kimg = min(ada_kimg, 100.0)
    if load_patches and device_feed in (True, "on"):
        raise ValueError("device_feed='on' is incompatible with load_patches (patch pixels "
                         "stay on the host)")

    dataset = LayoutDataset(data, background_size=gcfg.background_size,
                            max_text_length=gcfg.max_text_length, text_len_clip=gcfg.text_len_table,
                            load_patches=load_patches)
    use_device_feed = not load_patches and should_enable(dataset, device_feed)
    sampler = InfiniteSampler(len(dataset), rank=dp_rank, num_replicas=dp_size, seed=random_seed)
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
                     f"{num_workers} prefetch workers"
                     + (", patches decoded" if load_patches else ""))
    print(f"Dataset: {len(dataset)} samples, {dataset.num_bbox_labels} labels ({feed_desc})")
    if grid is not None:
        print(f"Ranks: {grid.world} = {dp_size} data x {grid.tp_size} model, "
              f"{local_batch} samples a rank a step")

    G, D = init_models(gcfg, device, dtype, random_seed)
    opt_g = build_optimizer(G.train(), lr=glr, reg_interval=g_reg_interval)
    opt_d = build_optimizer(D.train(), lr=dlr, reg_interval=d_reg_interval)
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
    if grid is not None:  # rank 0's weights everywhere (training_loop.py:176-179)
        distributed.broadcast_module_(G)
        distributed.broadcast_module_(D)
        tp.shard_module_(G, grid.tp_rank, grid.tp_size)
        tp.shard_module_(D, grid.tp_rank, grid.tp_size)
    if module_summary:
        _module_summaries(G, D, dataset, device)

    state = GANTrainState.create(G, D, opt_g, opt_d)
    if resume:
        restore_checkpoint(resume, state)
        print(f"Resumed from {resume} (restored state sha256 "
              f"{snapshot_digest(snapshot_of(state))})")
    share_te = _text_encoders_equal(state.G, state.D)
    print(f"Text-encoder sharing: {'ON (identical frozen weights)' if share_te else 'off'}")

    grad_accum = 1
    if batch_gpu is not None and batch_gpu < local_batch:
        if local_batch % batch_gpu:
            raise ValueError("--batch-gpu must divide a rank's batch")
        grad_accum = local_batch // batch_gpu
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
        # the patches are decoded (the reference's host work) but no loss reads them
        loader = PrefetchLoader(dataset, local_batch, sampler, num_workers=num_workers,
                                drop=("patches_orig",))
    collector = Collector()
    jsonl = StatsJsonlWriter(os.path.join(run_dir, "stats.jsonl")) if is_chief else None
    tb = TensorboardWriter(run_dir) if is_chief else None
    clock = _StepClock(device)
    generator = torch.Generator().manual_seed(distributed.rank_seed(random_seed, dp_rank))

    cur_nimg = resume_kimg * 1000
    cur_tick = 0
    tick_start_nimg = cur_nimg
    tick_start_time = time.time()
    maintenance_time = 0.0
    feed_s = 0.0
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
    world = grid.world if grid is not None else 1

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
            t_feed = time.perf_counter()
            if use_device_feed:
                idx = dcache.put_indices([next(sampler_it) for _ in range(local_batch)])
                batch = gather_batch(dcache.arrays, idx)
            else:
                batch = to_device(next(loader), device)
            feed_s += time.perf_counter() - t_feed
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
                # the mean over every rank: one p everywhere
                (sign,) = distributed.all_reduce_host([float(np.mean(ada_signs))])
                cur_aug_p = ada.update(batch_idx, batch_size, sign / world)
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
                     "main_step_s": step_s["main"], "reg_step_s": step_s["reg"],
                     "feed_s": feed_s}
            if aug != "noaug":
                fields.append(f"augment {cur_aug_p:.3f}")
                extra["augment_p"] = cur_aug_p
            if ada is not None:
                extra["ada_updates"] = ada.updates
            extra.update({f"launches/{k}": n for k, n in launch_counts().items()})
            print(" ".join(fields))
            if is_chief:
                jsonl.write(collector.as_dict(), extra=extra)
                for name in collector.names():
                    tb.scalar(name, collector.mean(name), cur_nimg)
                if aug != "noaug":
                    tb.scalar("Progress/augment", cur_aug_p, cur_nimg)
                tb.flush()

            if progress_fn is not None and is_chief:
                progress_fn(cur_nimg // 1000, total_kimg)
            abort = abort_fn is not None and abort_fn()
            if grid is not None:  # a signal to any rank ends every rank's run
                abort = distributed.all_reduce_host([float(abort)], op="max")[0] > 0
            done = done or abort
            image_tick = image_snapshot_ticks is not None and (
                done or cur_tick % image_snapshot_ticks == 0)
            network_tick = network_snapshot_ticks is not None and (
                done or cur_tick % network_snapshot_ticks == 0)
            view = _chief_view(state) if image_tick or network_tick else state
            if image_tick and is_chief:
                _save_image_snapshot(run_dir, view, dataset, cur_nimg, device)
            if network_tick:
                if grid is not None and grid.world > 1:
                    # the reference's check_ddp_consistency before every
                    # pickle (training_loop.py:402-405; JAX's :612-625)
                    check_replica_consistency({"G": state.G, "D": state.D, "G_ema": state.G_ema})
                snap_path = os.path.join(run_dir, f"network-snapshot-{cur_nimg // 1000:06d}.pt")
                save_checkpoint(snap_path, state)
                if is_chief:
                    write_gcfg(snap_path, gcfg)
                    # synchronous, as the reference's (training_loop.py:413-427),
                    # in the tick's maintenance: outside the sec/kimg clock
                    if metrics_fn is not None and (done or snap_count % metric_ticks == 0):
                        metrics_fn(view, snap_path, cur_nimg)
                snap_count += 1
            del view

            cur_tick += 1
            tick_start_nimg = cur_nimg
            tick_start_time = time.time()
            maintenance_time = tick_start_time - tick_end_time
            feed_s = 0.0
            if done:
                break
    finally:
        if loader is not None:
            loader.close()
        if tb is not None:
            tb.close()
    print(f"Kernel launches: {json.dumps(launch_counts())}")
    print("Training done.")
    return state
