"""Train LayoutDETR with the port.

    python -m layoutdetr_tpu_torch.train --outdir runs --data train.zip --batch 16 \\
        [--bf16] [--max-text-length auto] [--aug ada] [--gamma 1] [--pl-weight 2] \\
        [--device cuda] [--chips N] [--model-parallel M] [--load-patches]

Counterpart of the JAX package's ``train.py`` (reference train.py:128-305):
the same option names and defaults, the same derived loss weights
(train.py:262-275), the same run-dir layout (numbered subdirectories with
``training_options.json`` and ``log.txt``), and SIGTERM finishes the tick,
snapshots and exits. argparse instead of click. Differences:

- ``--device`` (default ``cuda``): where the run trains; ``cpu`` only
  when asked for;
- ``--metrics`` (default ``layout_fid50k_val``) runs at snapshot ticks,
  every ``--metric-ticks``, on G_ema where it lives (``make_metrics_fn``);
  ``--layoutnet-ckpt`` is a torch state dict;
- ``--remat`` is accepted and does nothing: batch 16 fits an 80 GB card.

Several GPUs, as JAX's ``--chips`` spans every visible chip
(train.py:6-7): ``--chips``/``--gpus`` N (default: every visible card)
runs one process per card, rank r on ``cuda:r``, over NCCL
(``parallel.distributed.spawn``); ``--model-parallel`` M folds the N ranks
into N/M data x M model ranks (``parallel.tensor_parallel``); ``--batch``
is the global batch. Asking for more cards than are visible is an error.
Under torchrun (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` set) this process
is that rank, on ``cuda:LOCAL_RANK``, and spawns nothing; several hosts
are one run:

    torchrun --nnodes 2 --node-rank {0,1} --nproc-per-node 8 \
        --master-addr HOST0 --master-port 29500 \
        -m layoutdetr_tpu_torch.train --outdir runs --data train.zip --batch 16

``--chips``/``--gpus`` there must equal torchrun's world size. Rank 0
writes the run directory; ``--resume`` reads the snapshot on every rank,
as the reference's DDP does, so the hosts need one shared file system
for it. ``--device cpu --chips N`` spawns N gloo ranks on the CPU (JAX's
virtual CPU mesh; a rehearsal); a CPU rank, spawned or torchrun's, runs
torch on one thread (``distributed.CPU_RANK_THREADS``), so both sum in one
order. One card and no torchrun: no process group, as before.

Importing this module starts nothing; ``main(argv)`` runs the CLI and
returns the final ``GANTrainState`` of a one-process run (None for
``--dry-run`` and for a spawned multi-rank run).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import signal
import sys
import time
from typing import Optional, Sequence

import torch

from layoutdetr_tpu_torch.config import GeneratorConfig
from layoutdetr_tpu_torch.training.loss import LossWeights

T_BUCKETS = (16, 32, 64, 128, 256)
TERM_REPEAT_S = 1.0  # SIGTERMs this close together are one stop request


def auto_text_length(measured: int) -> int:
    """``--max-text-length auto``: the smallest bucket of ``T_BUCKETS`` that
    holds ``measured`` tokens, else 256 (longer texts are truncated)."""
    return next((b for b in T_BUCKETS if b >= measured), 256)


def _ranged(kind, lo=None, hi=None):
    def parse(s):
        v = kind(s)
        if (lo is not None and v < lo) or (hi is not None and v > hi):
            raise argparse.ArgumentTypeError(f"{s} is not in [{lo}, {hi}]")
        return v
    return parse


def _bool(s: str) -> bool:
    v = s.strip().lower()
    if v in ("1", "true", "t", "yes", "y", "on"):
        return True
    if v in ("0", "false", "f", "no", "n", "off"):
        return False
    raise argparse.ArgumentTypeError(f"{s} is not a boolean")


def _max_text_length(s: str) -> str:
    """'auto' or a positive int."""
    s = str(s).strip()
    if s.lower() == "auto":
        return s
    if not s.isdigit() or int(s) < 1:
        raise argparse.ArgumentTypeError("must be 'auto' or a positive integer")
    return str(int(s))


def parse_comma_separated_list(s):
    if s is None or s.lower() == "none" or s == "":
        return []
    return s.split(",")


def _flag_pair(ap, on: str, off: str, dest: str, default, help: str = None):
    ap.add_argument(on, dest=dest, action="store_true", default=default, help=help)
    ap.add_argument(off, dest=dest, action="store_false", default=default)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m layoutdetr_tpu_torch.train",
                                 description="Train LayoutDETR with the PyTorch port.")
    nn_int = _ranged(int, 0)
    pos_int = _ranged(int, 1)
    nn_float = _ranged(float, 0.0)
    unit = _ranged(float, 0.0, 1.0)
    add = ap.add_argument
    add("--outdir", required=True, metavar="DIR")
    add("--data", required=True, metavar="[ZIP]")
    add("--batch", dest="batch_size", required=True, type=pos_int, metavar="INT")
    # loss weights (reference train.py:135-145)
    add("--gamma", dest="r1_gamma", type=nn_float, default=0.0)
    add("--pl-weight", type=nn_float, default=0.0)
    add("--bbox-cls-weight", type=nn_float, default=50.0)
    add("--bbox-rec-weight", type=nn_float, default=500.0)
    add("--text-rec-weight", type=nn_float, default=0.1)
    add("--text-len-rec-weight", type=nn_float, default=2.0)
    add("--im-rec-weight", type=nn_float, default=0.5)
    add("--bbox-giou-weight", type=nn_float, default=4.0)
    add("--overlapping-weight", type=nn_float, default=7.0)
    add("--alignment-weight", type=nn_float, default=17.0)
    add("--z-rec-weight", type=nn_float, default=5.0)
    # optional features
    add("--aug", choices=["noaug", "ada", "fixed"], default="noaug")
    _flag_pair(ap, "--aug-geom", "--no-aug-geom", "aug_geom", False,
               "include the geometric warps in the ADA pipe (off: CONDITIONAL_SAFE)")
    add("--resume", default=None, metavar="[PATH]", help="training snapshot to resume from")
    add("--init-g", default=None, help="checkpoint grafted onto the fresh G at cold start")
    add("--init-d", default=None, help="checkpoint grafted onto the fresh D at cold start")
    add("--resume-kimg", type=nn_int, default=0)
    # misc hyperparameters
    add("--p", dest="aug_p", type=unit, default=0.2)
    add("--target", dest="ada_target", type=unit, default=0.6)
    add("--batch-gpu", type=pos_int, default=None, help="microbatch (grad accumulation)")
    add("--glr", type=nn_float, default=1e-5)
    add("--dlr", type=nn_float, default=1e-5)
    # model hyperparameters (reference train.py:167-183)
    add("--z-dim", type=pos_int, default=4)
    add("--bert-f-dim", type=pos_int, default=768)
    add("--bert-num-heads", type=pos_int, default=4)
    add("--bert-num-encoder-layers", type=pos_int, default=12)
    add("--bert-num-decoder-layers", type=pos_int, default=2)
    add("--background-size", type=pos_int, default=256)
    add("--im-f-dim", type=pos_int, default=512)
    add("--max-text-length", type=_max_text_length, default="256",
        help="token dimension T, or 'auto': the smallest of 16/32/64/128/256 that holds the "
             "dataset's longest text (the char-length table stays 256)")
    add("--backbone", choices=["resnet50", "vit"], default="resnet50")
    # misc settings
    add("--desc", default=None)
    add("--metrics", type=parse_comma_separated_list, default="layout_fid50k_val",
        help="metrics run on the val set at snapshot ticks (comma-separated, or 'none'); "
             "val.zip beside train.zip, else the training zip")
    add("--metric-ticks", type=pos_int, default=1,
        help="run the metrics on every Nth network snapshot only")
    add("--layoutnet-ckpt", default=None,
        help="LayoutNet torch state dict for reference-scale layout FID; seed-0 random otherwise")
    add("--inception-ckpt", default=None,
        help="InceptionV3 weights (torch .pth in pytorch-fid naming, or a JAX .npz) for "
             "reference-scale image FID")
    add("--kimg", dest="total_kimg", type=pos_int, default=25000)
    add("--tick", dest="kimg_per_tick", type=pos_int, default=1)
    add("--snap", type=pos_int, default=100)
    add("--seed", type=nn_int, default=0)
    _flag_pair(ap, "--bf16", "--fp32", "use_bf16", False,
               "bf16 activations on the tensor cores (parameters stay fp32)")
    _flag_pair(ap, "--remat", "--no-remat", "remat", None, "accepted; the port does not rematerialize")
    add("--chips", type=pos_int, default=None,
        help="ranks, one a card (default: every visible card; 1 on the CPU)")
    add("--model-parallel", type=pos_int, default=1,
        help="tensor-parallel degree: the ranks fold into (data, model) groups")
    add("--max-steps", type=int, default=None, help="stop after N steps")
    add("-n", "--dry-run", action="store_true", default=False)
    # reference-CLI compatibility (SURVEY.md §2.10): accepted, no effect
    add("--gpus", type=pos_int, default=None, help="the reference's name of --chips")
    add("--cond", type=_bool, default=False)
    add("--mirror", type=_bool, default=False)
    add("--freezed", type=nn_int, default=0)
    add("--cbase", type=pos_int, default=32768)
    add("--cmax", type=pos_int, default=512)
    add("--map-depth", type=pos_int, default=None)
    add("--mbstd-group", type=nn_int, default=4)
    add("--nobench", type=_bool, default=False)
    add("--workers", type=nn_int, default=None,
        help="prefetch worker processes of the host loader (0: one thread; default min(8, cores))")
    _flag_pair(ap, "--load-patches", "--no-load-patches", "load_patches", False,
               "decode the elements' patch PNGs into every batch on the host (no loss reads "
               "them; the reference's full host I/O); needs the host loader")
    add("--device-feed", choices=["auto", "on", "off"], default="auto",
        help="keep the dataset on the card and feed indices (auto: when it fits "
             "LAYOUTDETR_DEVICE_CACHE_GB, default 4, and --load-patches is off)")
    add("--g-f-dim", type=pos_int, default=256)
    add("--g-num-heads", type=pos_int, default=4)
    add("--g-num-layers", type=pos_int, default=8)
    add("--d-f-dim", type=pos_int, default=256)
    add("--d-num-heads", type=pos_int, default=4)
    add("--d-num-layers", type=pos_int, default=8)
    add("--device", default="cuda", help="where to train (default cuda)")
    return ap


def _check_supported(ap: argparse.ArgumentParser, opts) -> None:
    from layoutdetr_tpu_torch.metrics import metric_main

    for m in opts.metrics:
        if not metric_main.is_valid_metric(m):
            ap.error(f"unknown metric {m}; valid: {metric_main.list_valid_metrics()}")
    if opts.load_patches and opts.device_feed == "on":
        ap.error("--device-feed on does not take --load-patches (the patches stay on the host)")


def _torchrun_rank() -> Optional[tuple]:
    """(rank, world, local rank) under torchrun's environment, else None."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    return (int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
            int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))


def _ranks(ap: argparse.ArgumentParser, opts, device: torch.device) -> int:
    """The run's rank count: torchrun's world size, else ``--chips``/
    ``--gpus``, else every visible card (1 on the CPU); an error when
    ``--chips`` disagrees with torchrun, past the visible cards, or when
    the model-parallel degree or the data-parallel share of the batch does
    not divide."""
    asked = opts.chips if opts.chips is not None else opts.gpus
    launched = _torchrun_rank()
    if launched is not None:
        world = launched[1]
        if asked is not None and asked != world:
            ap.error(f"--chips {asked}, but torchrun started {world} ranks (WORLD_SIZE)")
    elif device.type == "cuda":
        visible = torch.cuda.device_count()
        world = visible if asked is None else asked
        if world > visible:
            ap.error(f"--chips {world}, but {visible} CUDA device(s) are visible")
    else:
        world = asked or 1
    if world % opts.model_parallel:
        ap.error(f"--model-parallel {opts.model_parallel} does not divide {world} ranks")
    dp = world // opts.model_parallel
    if opts.batch_size % dp:
        ap.error(f"--batch {opts.batch_size} does not divide over {dp} data-parallel ranks")
    return world


def make_metrics_fn(opts, gcfg: GeneratorConfig, run_dir: str):
    """The metrics at snapshot ticks (JAX train.py:299-349, reference
    training_loop.py:413-427): ``opts.metrics`` on ``val.zip`` beside
    ``train.zip`` (else the training zip), tokenized at the run's T and
    char-length table, batch ``min(16, batch)``, on ``state.G_ema`` where
    it lives; each result appended to ``<run_dir>/metric-<name>.jsonl``."""
    from layoutdetr_tpu_torch.data.dataset import LayoutDataset
    from layoutdetr_tpu_torch.evaluate import load_layoutnet_state_dict
    from layoutdetr_tpu_torch.metrics import metric_main

    val_path = opts.data.replace("train.zip", "val.zip")
    if not os.path.exists(val_path):
        print(f"(no {val_path}; evaluating metrics on the training zip)")
        val_path = opts.data
    val_dataset = LayoutDataset(val_path, background_size=gcfg.background_size,
                                max_text_length=gcfg.max_text_length,
                                text_len_clip=gcfg.text_len_table)
    layoutnet = load_layoutnet_state_dict(opts.layoutnet_ckpt) if opts.layoutnet_ckpt else None

    def metrics_fn(state, snap_path: str, cur_nimg: int) -> None:
        for m in opts.metrics:
            result = metric_main.calc_metric(
                m, G=state.G_ema, dataset=val_dataset, layoutnet_params=layoutnet,
                inception_params=opts.inception_ckpt, batch=min(16, opts.batch_size),
                seed=opts.seed)
            metric_main.report_metric(result, run_dir=run_dir, snapshot_path=snap_path)

    return metrics_fn


def main(argv: Optional[Sequence[str]] = None):
    ap = build_parser()
    opts = ap.parse_args(argv)
    _check_supported(ap, opts)
    device = torch.device(opts.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda, but torch sees no CUDA device (--device cpu trains on the CPU)")
    world = _ranks(ap, opts, device)
    launched = _torchrun_rank()
    if launched is not None:  # this process is one rank of torchrun's
        from layoutdetr_tpu_torch.parallel import distributed

        rank, _, local = launched
        if rank:  # rank 0 prints for all
            sys.stdout = open(os.devnull, "w")
        rank_device = torch.device(f"cuda:{local}") if device.type == "cuda" else device
        if device.type == "cpu":  # as a spawned CPU rank: the same sums in one order
            torch.set_num_threads(distributed.CPU_RANK_THREADS)
        distributed.init(rank, world, opts.model_parallel, rank_device)
        try:
            import torch.distributed as dist

            run = [_prepare(opts, device, world) if rank == 0 else None]
            dist.broadcast_object_list(run, src=0)  # rank 0 numbers the run directory
            return None if run[0] is None else _train(opts, *run[0], rank == 0)
        finally:
            distributed.shutdown()

    run = _prepare(opts, device, world)
    if run is None:
        return None
    if world == 1:
        return _train(opts, *run, True)
    from layoutdetr_tpu_torch.parallel import distributed

    devices = [f"cuda:{r}" for r in range(world)] if device.type == "cuda" else ["cpu"] * world
    distributed.spawn(_rank_main, world, (opts, *run), model_parallel=opts.model_parallel,
                      devices=devices)
    return None


def _prepare(opts, device: torch.device, world: int):
    """The run's config, loss weights and numbered run directory (with
    ``training_options.json``), printed; None for ``--dry-run``."""
    from layoutdetr_tpu_torch.data.dataset import LayoutDataset

    auto_text_len = opts.max_text_length.lower() == "auto"
    max_text_length = 256 if auto_text_len else int(opts.max_text_length)
    probe = LayoutDataset(opts.data, background_size=opts.background_size,
                          max_text_length=max_text_length, cache=False)
    if auto_text_len:
        measured = probe.measured_max_text_tokens()
        max_text_length = auto_text_length(measured)
        trunc = "" if measured <= 256 else f" (longest text is {measured} tokens; truncated)"
        print(f"--max-text-length auto: dataset max token length {measured} "
              f"-> T={max_text_length}{trunc}")

    gcfg = GeneratorConfig(
        z_dim=opts.z_dim, num_bbox_labels=probe.num_bbox_labels, bert_f_dim=opts.bert_f_dim,
        bert_num_heads=opts.bert_num_heads, bert_num_encoder_layers=opts.bert_num_encoder_layers,
        bert_num_decoder_layers=opts.bert_num_decoder_layers, im_f_dim=opts.im_f_dim,
        background_size=opts.background_size, max_text_length=max_text_length,
        # an explicit --max-text-length N sizes the char-length table to N
        # (networks_detr.py:103,149); auto keeps it at 256
        text_len_table=256 if auto_text_len else max_text_length, backbone=opts.backbone)
    weights = LossWeights(  # reference train.py:262-275
        Dreal_bbox_cls_weight=opts.bbox_cls_weight, Ggen_bbox_cls_weight=opts.bbox_cls_weight,
        Dreal_bbox_rec_weight=opts.bbox_rec_weight, Ggen_bbox_rec_weight=opts.bbox_rec_weight / 5.0,
        Dreal_text_rec_weight=opts.text_rec_weight, Ggen_text_rec_weight=opts.text_rec_weight * 10.0,
        Dreal_text_len_rec_weight=opts.text_len_rec_weight,
        Ggen_text_len_rec_weight=opts.text_len_rec_weight / 2.0,
        Dreal_im_rec_weight=opts.im_rec_weight, Ggen_bbox_gIoU_weight=opts.bbox_giou_weight,
        Ggen_overlapping_weight=opts.overlapping_weight,
        Ggen_alignment_weight=opts.alignment_weight, Ggen_z_rec_weight=opts.z_rec_weight,
        pl_weight=opts.pl_weight, r1_gamma=opts.r1_gamma)

    # run-dir numbering (reference train.py:55-62)
    prev = [re.match(r"^\d+", x) for x in (os.listdir(opts.outdir) if os.path.isdir(opts.outdir) else [])]
    cur_id = max((int(m.group()) for m in prev if m), default=-1) + 1
    desc = f"{probe.name}-batch{opts.batch_size:d}" + (f"-{opts.desc}" if opts.desc else "")
    run_dir = os.path.join(opts.outdir, f"{cur_id:05d}-{desc}")
    cfg = dict(run_dir=run_dir, data=opts.data, batch_size=opts.batch_size, glr=opts.glr,
               dlr=opts.dlr, total_kimg=opts.total_kimg, kimg_per_tick=opts.kimg_per_tick,
               network_snapshot_ticks=opts.snap, random_seed=opts.seed, resume=opts.resume,
               resume_kimg=opts.resume_kimg, num_samples=len(probe), metrics=opts.metrics,
               gcfg=gcfg.to_dict(), loss_weights=dataclasses.asdict(weights), aug=opts.aug,
               ada_target=opts.ada_target if opts.aug == "ada" else None, bf16=opts.use_bf16,
               ema_kimg=opts.batch_size * 10 / 32, device=str(device), ranks=world,
               model_parallel=opts.model_parallel, load_patches=opts.load_patches)
    print()
    print("Training options:")
    print(json.dumps(cfg, indent=2, default=str))
    print()
    print(f"Output directory:    {run_dir}")
    print(f"Training data:       {opts.data} ({len(probe)} samples)")
    print(f"Device:              {device}"
          + (f" x {world} ranks ({world // opts.model_parallel} data x {opts.model_parallel} "
             f"model)" if world > 1 else ""))
    if opts.dry_run:
        print("Dry run; exiting.")
        return None

    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "training_options.json"), "w") as f:
        json.dump(cfg, f, indent=2, default=str)
    return gcfg, weights, run_dir


def _rank_main(opts, gcfg: GeneratorConfig, weights: LossWeights, run_dir: str) -> None:
    """One spawned rank of ``main``, inside its grid."""
    from layoutdetr_tpu_torch.parallel import distributed

    _train(opts, gcfg, weights, run_dir, distributed.grid().is_chief)


class StopRequest:
    """The SIGTERM handler of a run: the first SIGTERM asks the loop to
    finish its tick, snapshot and exit (``requested``); one sent
    TERM_REPEAT_S or more later kills at once. Closer together they are
    one stop that arrived twice: GNU timeout (``tools/run_stability_torch.sh``)
    signals its child and then its process group, which holds the child."""

    def __init__(self):
        self.requested = False
        self._at = 0.0

    def __call__(self, signum, frame) -> None:
        if self.requested:
            if time.monotonic() - self._at < TERM_REPEAT_S:
                return
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)
        self.requested, self._at = True, time.monotonic()
        print("\nSIGTERM: finishing tick, snapshotting, then exiting (send again to kill now)",
              flush=True)


def _train(opts, gcfg: GeneratorConfig, weights: LossWeights, run_dir: str, chief: bool):
    """The training run of this process (a rank, or the whole run): rank 0
    alone keeps ``log.txt`` and runs the metrics."""
    from layoutdetr_tpu_torch.training.train_loop import training_loop
    from layoutdetr_tpu_torch.utils.logging import Logger
    from layoutdetr_tpu_torch.utils.misc import enable_stack_dumps

    device = torch.device(opts.device)
    metrics_fn = make_metrics_fn(opts, gcfg, run_dir) if opts.metrics and chief else None
    enable_stack_dumps()
    term = StopRequest()
    old_handler = signal.signal(signal.SIGTERM, term)
    logger = Logger(os.path.join(run_dir, "log.txt")) if chief else None
    try:
        return training_loop(
            run_dir=run_dir, data=opts.data, gcfg=gcfg,
            dtype=torch.bfloat16 if opts.use_bf16 else torch.float32, loss_weights=weights,
            batch_size=opts.batch_size, batch_gpu=opts.batch_gpu, glr=opts.glr, dlr=opts.dlr,
            total_kimg=opts.total_kimg, kimg_per_tick=opts.kimg_per_tick,
            network_snapshot_ticks=opts.snap, image_snapshot_ticks=opts.snap,
            random_seed=opts.seed, resume=opts.resume, resume_kimg=opts.resume_kimg,
            init_g=opts.init_g, init_d=opts.init_d, num_workers=opts.workers,
            device_feed=opts.device_feed, max_steps=opts.max_steps, aug=opts.aug,
            aug_p=opts.aug_p, aug_geom=opts.aug_geom, ada_target=opts.ada_target,
            ema_rampup=0.05, ada_kimg=500.0, abort_fn=lambda: term.requested, device=device,
            metrics_fn=metrics_fn, metric_ticks=opts.metric_ticks, load_patches=opts.load_patches)
    finally:
        if logger is not None:
            logger.close()
        signal.signal(signal.SIGTERM, old_handler)


if __name__ == "__main__":
    main()
