"""Tensor parallelism: JAX's ``TP_RULES`` over the model axis of the grid.

Counterpart of ``layoutdetr_tpu/parallel/mesh.py:117-173`` (``TP_RULES``,
``shard_params``), with the same rules in the port's parameter names and
the Megatron layout written out where GSPMD infers it:

- column-parallel (a rank holds a slice of the outputs, ``weight`` rows
  and ``bias``): BERT's ``query``/``key``/``value`` and
  ``intermediate.dense``, the transformers' ``linear1``;
- row-parallel (a rank holds a slice of the inputs, ``weight`` columns;
  the bias stays whole): BERT's ``attention.output.dense`` and
  ``crossattention.output.dense``, the FFN's ``output.dense``, the
  transformers' ``linear2``;
- everything else is replicated, as JAX keeps it: the packed ``in_proj``
  of the DETR attention (a split of its 3d axis misaligns with q/k/v,
  ``mesh.py:133-145``) and the convolutions.

``shard_module_`` only slices parameters; each layer reads its role from
its weights' shapes (``models.layers.Dense``, ``BertSelfAttention``,
the transformers' FFN) and its place from ``model_slice``. A
column-parallel ``Dense`` takes its input through ``copy_to_model``
(identity forward, all_reduce of the gradient backward: Megatron's f),
a row-parallel one sums its partial products with ``reduce_from_model``
(all_reduce forward, identity backward: g) and then adds its bias. So
each BERT block and each FFN costs one all_reduce forward and one
backward. Each one's backward is the other one, applied as a function,
so a gradient taken with ``create_graph`` (the path-length and R1
penalties) differentiates again across the ranks. BERT's self-attention
then runs the rank's heads (H / tp, the head dim stays H's), through the
fused kernel too: JAX falls back to XLA attention under TP only because
GSPMD cannot partition a pallas_call (``models/generator.py:165-187``).
Dropout on a sharded activation (the attention probabilities of the
plain path, the FFN's hidden units) draws the whole layer's mask and
keeps the rank's slice, and the kernel's keep mask is keyed by the
global head, so a TP step drops what the one-process step drops.

``shard_state_dict`` maps a full state dict to a rank's (a pure
function); ``shard_module_`` shards a built module in place;
``gather_state_dict``, its inverse, gives every rank the full tensors (an
all_reduce of zero-filled buffers: exact), which a snapshot holds, so it
loads into any layout.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from layoutdetr_tpu_torch.parallel import distributed

# (name suffix, sharded dim of the torch tensor), first match wins:
# weight [out, in]: 0 = column-parallel, 1 = row-parallel.
TP_RULES = (
    ("query.weight", 0), ("key.weight", 0), ("value.weight", 0),
    ("query.bias", 0), ("key.bias", 0), ("value.bias", 0),
    ("attention.output.dense.weight", 1),
    ("crossattention.output.dense.weight", 1),
    # the FFN down-projection (layer.N.output.dense), after the attention rules
    ("intermediate.dense.weight", 0), ("intermediate.dense.bias", 0),
    ("output.dense.weight", 1),
    ("linear1.weight", 0), ("linear1.bias", 0), ("linear2.weight", 1),
)


def tp_dim(name: str) -> Optional[int]:
    """The dim of parameter ``name`` that TP shards, None if replicated."""
    for suffix, dim in TP_RULES:
        if name == suffix or name.endswith("." + suffix):
            return dim
    return None


def _chunk(t: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    if t.shape[dim] % size:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split into {size}")
    n = t.shape[dim] // size
    return t.narrow(dim, rank * n, n)


def shard_state_dict(sd: Dict[str, torch.Tensor], tp_rank: int, tp_size: int) -> dict:
    """Rank ``tp_rank``'s state dict of the full ``sd`` (copies of the
    slices; replicated entries as they are)."""
    out = {}
    for name, t in sd.items():
        dim = tp_dim(name)
        out[name] = t if dim is None or tp_size == 1 else _chunk(t, dim, tp_rank, tp_size).clone()
    return out


# ---------------------------------------------------------------------------
# Megatron's f and g
# ---------------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _ReduceFromModel.apply(dy, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        return _CopyToModel.apply(dy, ctx.group), None


def _tp_group():
    g = distributed.grid()
    if g is None or g.tp_size == 1:
        raise RuntimeError("a tensor-parallel layer runs outside a grid with a model axis")
    return g.tp_group


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Megatron's f: the input of a column-parallel layer."""
    return _CopyToModel.apply(x, _tp_group())


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """Megatron's g: the sum of a row-parallel layer's partial products."""
    return _ReduceFromModel.apply(x, _tp_group())


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def model_shard() -> Optional[Tuple[int, int]]:
    """(model index, model group size) of this rank in a grid with a model
    axis, where the training state is sharded; None otherwise."""
    g = distributed.grid()
    return None if g is None or g.tp_size == 1 else (g.tp_rank, g.tp_size)


def model_slice(full: int, local: int) -> Optional[Tuple[int, int]]:
    """(index, count) of the slice a layer holds when it has ``local`` of
    its ``full`` units (heads, hidden units): None when whole, else this
    rank's model index and the model group's size."""
    if local == full:
        return None
    g = distributed.grid()
    if g is None or g.tp_size * local != full:
        raise RuntimeError(f"a layer holds {local} of {full} units outside a grid of "
                           f"{full // max(local, 1)} model ranks")
    return g.tp_rank, g.tp_size


def shard_module_(module: nn.Module, tp_rank: int, tp_size: int) -> nn.Module:
    """Shard ``module`` in place by ``TP_RULES``: the parameters keep their
    identity (an optimizer built on them stays valid), hold the rank's
    slice and carry ``tp_dim`` (``distributed.average_gradients`` reads
    it). The layers see their role in their weights' shapes."""
    if tp_size == 1:
        return module
    with torch.no_grad():
        for name, p in module.named_parameters():
            dim = tp_dim(name)
            if dim is None:
                continue
            if getattr(p, "tp_dim", None) is not None:
                raise ValueError(f"{name} is already sharded")
            p.data = _chunk(p.data, dim, tp_rank, tp_size).clone()
            p.tp_dim = dim
    return module


def unsharded_copy(module: nn.Module, full_sd: Dict[str, torch.Tensor]) -> nn.Module:
    """A copy of the sharded ``module`` that computes alone, holding the
    full tensors ``full_sd`` (``gather_state_dict``'s)."""
    out = copy.deepcopy(module)
    with torch.no_grad():
        for name, p in out.named_parameters():
            p.data = full_sd[name].to(p.device)
            p.__dict__.pop("tp_dim", None)
    return out


@torch.no_grad()
def gather_state_dict(sd: Dict[str, torch.Tensor], tp_rank: int, tp_size: int,
                      group=None) -> dict:
    """Every rank's full state dict from the ranks' ``sd`` (collective over
    the TP ``group``): a sharded entry is summed over the group into a
    zero-filled full buffer, where each rank fills its slice."""
    if tp_size == 1:
        return dict(sd)
    out = {}
    for name, t in sd.items():
        dim = tp_dim(name)
        if dim is None or t.dim() == 0:
            out[name] = t
            continue
        shape = list(t.shape)
        shape[dim] *= tp_size
        full = t.new_zeros(shape)
        full.narrow(dim, tp_rank * t.shape[dim], t.shape[dim]).copy_(t)
        dist.all_reduce(full, group=group)
        out[name] = full
    return out


def trainable_names(module: nn.Module) -> List[str]:
    """Names of the parameters an optimizer built by
    ``training.optimizers.build_optimizer`` holds, in its order."""
    return [n for n, p in module.named_parameters() if p.requires_grad]


def _map_optimizer_state(osd: dict, names: Sequence[str], fn) -> dict:
    """``osd`` with every per-parameter tensor t of a sharded parameter
    replaced by fn(name, t) (the Adam moments; ``step`` stays)."""
    state = {}
    for idx, entry in osd["state"].items():
        name = names[int(idx)]
        state[idx] = {k: fn(name, v) if isinstance(v, torch.Tensor) and v.dim() > 0
                      and tp_dim(name) is not None else v for k, v in entry.items()}
    return dict(osd, state=state)


def shard_optimizer_state_dict(osd: dict, names: Sequence[str], tp_rank: int,
                               tp_size: int) -> dict:
    """Rank ``tp_rank``'s optimizer state dict from the full ``osd``;
    ``names`` are the optimizer's parameters (``trainable_names``)."""
    if tp_size == 1:
        return osd
    return _map_optimizer_state(
        osd, names, lambda n, t: _chunk(t, tp_dim(n), tp_rank, tp_size).clone())


def gather_optimizer_state_dict(osd: dict, names: Sequence[str], tp_rank: int, tp_size: int,
                                group=None) -> dict:
    """The full optimizer state dict from the ranks' (collective)."""
    if tp_size == 1:
        return osd

    def gather(name, t):
        return gather_state_dict({name: t}, tp_rank, tp_size, group)[name]

    return _map_optimizer_state(osd, names, gather)
