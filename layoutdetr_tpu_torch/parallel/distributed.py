"""Process groups for multi-GPU training: the rank grid, the collectives of
a data-parallel step, and the launcher.

Counterpart of ``layoutdetr_tpu/parallel/mesh.py:28-114`` (``make_mesh``,
``shard_batch``, ``replicate``). JAX runs one program over a device mesh
and XLA inserts the collectives; here each card runs its own process
(rank), as in the reference (train.py:31-38 NCCL process group,
training_loop.py:176-179 parameter broadcast, :305-312 flat gradient
all_reduce), and the collectives are written out:

- ``init`` joins the process group (NCCL on ``cuda``, gloo on ``cpu``;
  ``backend='gloo'`` also on ``cuda``, which is how two ranks rehearse on
  one card: NCCL refuses two ranks on one device) and builds the
  ``Grid``: ``world = data x model`` ranks, the model axis inner and
  contiguous (``mesh.py:38-40``), rank r at (r // model, r % model), with
  a data-parallel (DP) group per model index and a tensor-parallel (TP)
  group per data index;
- ``broadcast_`` puts rank 0's parameters and buffers on every rank;
- ``average_gradients`` averages gradients in flat buckets: a TP-sharded
  parameter's over the DP group, every other over all ranks (a model
  group's copies are equal in exact arithmetic; the average keeps them
  equal bit for bit where a kernel sums in a run-dependent order, as
  cuDNN's weight gradients and the CPU's threads may);
- ``global_shares`` and ``data_mean`` serve the loss terms
  (``training.loss``) that average over the global batch: the factor
  that turns a rank's masked mean into its share of the global one (the
  counts of valid entries all-reduced over the DP group), and a mean
  all-reduced with its gradient;
- ``spawn`` runs a function in N processes, one rank each, with a
  deadline.

Only ``all_reduce`` and ``broadcast`` touch device tensors: gloo runs
those two on CUDA tensors, so every collective here can be rehearsed
with two ranks on one card. With no grid (one process, the default)
every function is the identity or a plain local computation; with a grid
of one rank the collectives still run (an NCCL group of one rank computes
what no group computes, bit for bit).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import signal
import socket
import sys
import time
from typing import Callable, Iterable, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

BUCKET_BYTES = 64 * 2 ** 20  # a flat bucket of the gradient all_reduce and the broadcast
# Torch threads of a CPU rank, spawned or torchrun's. The CPU's
# multi-threaded kernels sum in an order that changes from run to run (seen
# as ~1e-7 in D's losses at the second step between two runs of one command
# at 4 threads a rank); on one thread a rank's sums keep one order, so a
# torchrun rank and a spawned one agree bit for bit.
CPU_RANK_THREADS = 1
# how long a collective waits: a snapshot tick's metrics run on rank 0 alone
TIMEOUT = datetime.timedelta(hours=1)


@dataclasses.dataclass
class Grid:
    """This process's place in the (data, model) rank grid."""

    rank: int
    world: int
    dp_size: int
    tp_size: int
    device: torch.device
    dp_group: object = dataclasses.field(repr=False)
    tp_group: object = dataclasses.field(repr=False)

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp_size

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp_size

    @property
    def is_chief(self) -> bool:
        return self.rank == 0


_GRID: Optional[Grid] = None


def grid() -> Optional[Grid]:
    """The current grid, None in a process that trains alone."""
    return _GRID


def grid_coords(rank: int, model_parallel: int) -> tuple:
    """(data index, model index) of ``rank``: the model axis is inner."""
    return rank // model_parallel, rank % model_parallel


def make_grid(model_parallel: int = 1, device=None) -> Grid:
    """The grid over the initialised process group, ``model_parallel``
    ranks a model group. Every rank must call it (``new_group`` is
    collective), and may call it again for another fold of the same
    ranks; it becomes the current grid."""
    global _GRID
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % model_parallel:
        raise ValueError(f"{world} ranks do not fold into model groups of {model_parallel}")
    dp = world // model_parallel
    dp_groups = [dist.new_group([d * model_parallel + t for d in range(dp)])
                 for t in range(model_parallel)]
    tp_groups = [dist.new_group([d * model_parallel + t for t in range(model_parallel)])
                 for d in range(dp)]
    d, t = grid_coords(rank, model_parallel)
    device = torch.device(device) if device is not None else (
        _GRID.device if _GRID is not None else torch.device("cpu"))
    _GRID = Grid(rank=rank, world=world, dp_size=dp, tp_size=model_parallel, device=device,
                 dp_group=dp_groups[t], tp_group=tp_groups[d])
    return _GRID


def init(rank: int, world: int, model_parallel: int = 1, device="cuda",
         backend: Optional[str] = None, init_method: str = "env://") -> Grid:
    """Join the process group as ``rank`` of ``world`` and make the grid.
    ``device`` is this rank's device (``cuda:r`` of its card); ``backend``
    defaults to NCCL on a card and gloo on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=TIMEOUT)
    return make_grid(model_parallel, device)


def shutdown() -> None:
    """Leave the process group; the process trains alone again."""
    global _GRID
    _GRID = None
    if dist.is_initialized():
        dist.destroy_process_group()


def rank_seed(seed: int, dp_rank: int) -> int:
    """The seed of a data-parallel rank's host generator (z, ADA, dropout):
    ``seed`` itself on rank 0, another stream on every other rank. The
    ranks of one model group share it: they hold one batch."""
    return (seed + 0x9E3779B97F4A7C15 * dp_rank) % 2 ** 63


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def buckets(tensors: Iterable[torch.Tensor], cap: int = BUCKET_BYTES) -> Iterator[List[int]]:
    """Indices of ``tensors`` in groups of one dtype and at most ``cap``
    bytes (a larger tensor is a group of its own), in order within a dtype."""
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append((i, t.numel() * t.element_size()))
    for items in by_dtype.values():
        group, size = [], 0
        for i, n in items:
            if group and size + n > cap:
                yield group
                group, size = [], 0
            group.append(i)
            size += n
        if group:
            yield group


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat_(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    i = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[i:i + n].view_as(t))
        i += n


def average_gradients(grads: List[Optional[torch.Tensor]], params: Sequence[torch.Tensor]) -> None:
    """Average ``grads`` of ``params`` (None stays None) in place, in flat
    buckets: the reference's flattened all_reduce (training_loop.py:305-312).
    A parameter that tensor parallelism shards (``tp_dim``, set by
    ``tensor_parallel.shard_module_``) over the DP group, every other over
    all ranks. Every rank passes the same list of shapes."""
    g = _GRID
    if g is None:
        return
    for sharded, group, size in ((True, g.dp_group, g.dp_size), (False, None, g.world)):
        present = [x for x, p in zip(grads, params)
                   if x is not None and (getattr(p, "tp_dim", None) is not None) == sharded]
        for idx in buckets(present):
            bucket = [present[i] for i in idx]
            flat = _flat(bucket)
            dist.all_reduce(flat, group=group)
            flat /= size
            _unflat_(flat, bucket)


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Rank ``src``'s values of ``tensors`` on every rank, in place
    (training_loop.py:176-179), in flat buckets."""
    if _GRID is None:
        return
    tensors = list(tensors)
    for idx in buckets(tensors):
        group = [tensors[i] for i in idx]
        flat = _flat(group)
        dist.broadcast(flat, src=src)
        _unflat_(flat, group)


def broadcast_module_(module: torch.nn.Module, src: int = 0) -> None:
    """Rank ``src``'s parameters and buffers on every rank."""
    broadcast_([t.data for t in module.parameters()]
               + [b for b in module.buffers() if b.is_floating_point()], src)


def global_shares(counts: torch.Tensor) -> torch.Tensor:
    """dp_size x ``counts`` / their totals over the DP group (each at least
    1): the factors that turn this rank's masked means over ``counts``
    valid entries into its shares of the global batch's means. A rank's
    mean S / n times dp x n / N is dp x S / N, and the ranks' average of
    those is the global mean sum(S) / N, as JAX's SPMD step computes it.
    Needs a grid; no gradient."""
    total = counts.detach().clone()
    dist.all_reduce(total, group=_GRID.dp_group)
    return counts.detach() * _GRID.dp_size / total.clamp(min=1.0)


class _DataMean(torch.autograd.Function):
    """Mean over a group, forward and backward (the backward sums the
    ranks' upstream gradients: every rank's input feeds every rank's
    output; it is this function again, so it differentiates again)."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y / size

    @staticmethod
    def backward(ctx, dy):
        return _DataMean.apply(dy, ctx.group, ctx.size), None, None


def data_mean(x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over all ranks, differentiable (``x`` itself with no
    grid): a mean over the global batch from the data ranks' means of equal
    shares (a model group's ranks hold equal copies), e.g. the path-length
    mean."""
    g = _GRID
    if g is None:
        return x
    return _DataMean.apply(x, None, g.world)


def all_reduce_host(values: Sequence[float], op: str = "sum", group=None) -> List[float]:
    """Host floats reduced over ``group`` (default: all ranks) on the
    grid's device: the Collector's moments, ADA's sign, the abort flag."""
    g = _GRID
    if g is None:
        return list(values)
    t = torch.tensor(list(values), dtype=torch.float64, device=g.device)
    dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op], group=group)
    return t.tolist()


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def free_port() -> int:
    """A free TCP port on 127.0.0.1 for the group's rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank: int, fn: Callable, world: int, model_parallel: int, devices: Sequence[str],
           backend: Optional[str], init_method: str, args: tuple) -> None:
    if rank:  # rank 0 prints for all
        sys.stdout = open(os.devnull, "w")
    device = torch.device(devices[rank])
    if device.type == "cpu":
        torch.set_num_threads(CPU_RANK_THREADS)
    init(rank, world, model_parallel, device, backend, init_method)
    try:
        fn(*args)
    finally:
        shutdown()


def spawn(fn: Callable, nprocs: int, args: tuple = (), *, model_parallel: int = 1,
          devices: Optional[Sequence[str]] = None, backend: Optional[str] = None,
          timeout_s: Optional[float] = None) -> None:
    """Run ``fn(*args)`` in ``nprocs`` spawned processes, rank r on
    ``devices[r]`` (default ``cuda:r``), each inside its grid (``init``).
    ``fn`` must be importable by name (a module-level function). Raises if
    a rank fails (the others are ended) or, with ``timeout_s``, when the
    ranks have not all ended by then (all are ended). A SIGTERM to this
    process is passed on to the ranks."""
    import torch.multiprocessing as mp

    devices = list(devices) if devices is not None else [f"cuda:{r}" for r in range(nprocs)]
    if len(devices) != nprocs:
        raise ValueError(f"{len(devices)} devices for {nprocs} ranks")
    init_method = f"tcp://127.0.0.1:{free_port()}"
    ctx = mp.spawn(_entry, args=(fn, nprocs, model_parallel, devices, backend, init_method, args),
                   nprocs=nprocs, join=False)

    def forward_term(signum, frame):
        for p in ctx.processes:
            if p.is_alive():
                os.kill(p.pid, signal.SIGTERM)

    try:
        old = signal.signal(signal.SIGTERM, forward_term)
    except ValueError:  # not the main thread: the ranks take their own signals
        old = None
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(f"{nprocs} ranks still running after {timeout_s} s")
    finally:
        if old is not None:
            signal.signal(signal.SIGTERM, old)
