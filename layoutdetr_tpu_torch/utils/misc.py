"""Runtime checks and introspection of a training run.

Counterparts of ``layoutdetr_tpu/utils/misc.py`` (reference
torch_utils/misc.py): ``print_module_summary`` (the reference's startup
table of every submodule's parameters and output shapes, misc.py:199-267,
here from forward hooks over one forward), ``nan_guard`` and
``enable_stack_dumps``. The replica check waits for multi-GPU.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn


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
