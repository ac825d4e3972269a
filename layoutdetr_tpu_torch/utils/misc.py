"""Runtime checks and introspection of a training run.

Counterparts of ``layoutdetr_tpu/utils/misc.py`` (reference
torch_utils/misc.py): ``print_module_summary`` (the reference's startup
table of every submodule's parameters and output shapes, misc.py:199-267,
here from forward hooks over one forward), ``nan_guard`` and
``enable_stack_dumps`` and ``check_replica_consistency`` (the training
loop's check before a network snapshot of a multi-rank run).
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.distributed as dist
from torch import nn

from layoutdetr_tpu_torch.parallel import distributed
from layoutdetr_tpu_torch.parallel.tensor_parallel import tp_dim


def _shapes(out) -> list:
    if isinstance(out, torch.Tensor):
        return [tuple(out.shape)]
    if isinstance(out, (tuple, list)):
        return [s for o in out for s in _shapes(o)]
    return []


def print_module_summary(module: nn.Module, *inputs, max_depth: int = 2, **kwargs) -> str:
    """Run ``module(*inputs, **kwargs)`` once without gradients and print one
    row per submodule down to ``max_depth``: name, parameters (its own
    subtree), output shapes. Returns the table."""
    rows: Dict[str, list] = {}
    hooks = []
    for name, sub in module.named_modules():
        depth = 0 if not name else name.count(".") + 1
        if depth > max_depth:
            continue

        def hook(_mod, _args, out, name=name):
            rows.setdefault(name, []).extend(_shapes(out))

        hooks.append(sub.register_forward_hook(hook))
    try:
        with torch.no_grad():
            module(*inputs, **kwargs)
    finally:
        for h in hooks:
            h.remove()
    subs = dict(module.named_modules())
    lines = [f"{'Module':<40} {'Parameters':>12}  Output shapes", "-" * 80]
    for name, shapes in rows.items():
        n = sum(p.numel() for p in subs[name].parameters())
        shown = ", ".join(str(list(s)) for s in shapes[:3]) + (" ..." if len(shapes) > 3 else "")
        lines.append(f"{name or '<top>':<40} {n:>12,}  {shown}")
    lines.append("-" * 80)
    total = sum(p.numel() for p in module.parameters())
    trainable = sum(p.numel() for p in module.parameters() if p.requires_grad)
    lines.append(f"{'Total':<40} {total:>12,}  ({trainable:,} trainable)")
    table = "\n".join(lines)
    print(table)
    return table


def nan_guard(tensors: Dict[str, torch.Tensor], where: str = "") -> None:
    """Raise if any tensor holds a non-finite value (a debugging aid; it
    waits for the device)."""
    for name, t in tensors.items():
        if not torch.isfinite(t).all():
            raise FloatingPointError(f"non-finite values at {where}{name}")


_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


@torch.no_grad()
def check_replica_consistency(tree: Mapping[str, object]) -> None:
    """Raise ``AssertionError("Replica mismatch at <name>")`` unless every
    replicated tensor of ``tree`` (name -> module or state dict) is equal
    bit for bit on every rank: the counterpart of
    layoutdetr_tpu/utils/misc.py:45-66 (reference misc.py:183-194
    check_ddp_consistency). Rank 0's values are broadcast in flat buckets
    and each rank compares its own bits; the mismatches are summed over
    the ranks, so every rank raises on the same name. Tensors that tensor
    parallelism shards (``tp_dim``, in a grid with a model axis) hold
    different slices and are skipped. Collective; a no-op without a grid."""
    g = distributed.grid()
    if g is None:
        return
    names, tensors = [], []
    for key, obj in tree.items():
        sd = obj.state_dict() if isinstance(obj, nn.Module) else obj
        for name, t in sd.items():
            if g.tp_size > 1 and tp_dim(name) is not None:
                continue
            names.append(f"{key}/{name}")
            # compare bits (NaN included) as integers of the element's width
            tensors.append(t.detach().reshape(-1).view(_BITS[t.element_size()]))
    flags = torch.zeros(len(names), device=g.device)
    for idx in distributed.buckets(tensors):
        mine = torch.cat([tensors[i].to(g.device) for i in idx])
        ref = mine.clone()
        dist.broadcast(ref, src=0)
        offset = 0
        for i in idx:
            n = tensors[i].numel()
            flags[i] = float(not torch.equal(mine[offset:offset + n], ref[offset:offset + n]))
            offset += n
    dist.all_reduce(flags)
    bad = flags.nonzero()
    if len(bad):
        raise AssertionError(f"Replica mismatch at {names[int(bad[0])]}")


def enable_stack_dumps() -> None:
    """``kill -USR1 <pid>`` prints every thread's Python stack to stderr."""
    import faulthandler
    import signal

    try:
        faulthandler.enable()
        faulthandler.register(signal.SIGUSR1, all_threads=True)
    except (AttributeError, ValueError, RuntimeError, OSError, ImportError):
        # no SIGUSR1 on this platform, or stderr has no real file descriptor
        # (a captured stream): the dumps are a diagnostic, never fatal
        pass
