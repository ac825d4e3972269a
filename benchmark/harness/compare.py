"""The numbers that decide ``correct``: gaps between the program's readings
and the reference's, each a relative gap taken by the worst case.

Norms are compared leaf by leaf as norms (the gap between the program's
norm and the reference's, not the norm of their difference), against the
reference's norm of that leaf or of the group's median leaf, whichever is
larger, since some gradients are all but zero.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Sequence

# A leaf whose reference gradient is under this share of the median leaf's
# norm, or an entry whose gradient is under this share of its own leaf's
# root mean square, in every checked step, moves under Adam by round-off
# alone, as a key's bias does under softmax: it is left out of the change.
ROUND_OFF_SHARE = 1e-3


def scalar_gap(program: Sequence[float], reference: Sequence[float]) -> float:
    """Largest |p - r| / |r| over paired scalars."""
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(program, reference))


def leaf_gaps(program: Sequence[float], reference: Sequence[float],
              keep: Sequence[bool] = None) -> List[float]:
    """|p - r| / max(r, median r) of each leaf's norms; 0 where not kept."""
    med = statistics.median(r for i, r in enumerate(reference) if keep is None or keep[i])
    return [abs(p - r) / max(r, med, 1e-30) if keep is None or keep[i] else 0.0
            for i, (p, r) in enumerate(zip(program, reference))]


def moved(grad_norms: Sequence[float], kept: Sequence[bool] = None) -> list:
    """Which leaves the reference's gradient of one step moves beyond
    round-off, or-ed into ``kept`` (the earlier steps')."""
    med = statistics.median(grad_norms)
    hit = [g >= ROUND_OFF_SHARE * med for g in grad_norms]
    return hit if kept is None else [a or b for a, b in zip(kept, hit)]


def moved_entries(grads: Sequence["torch.Tensor"], kept: Sequence["torch.Tensor"] = None) -> list:
    """Per leaf, a bool mask of the entries the reference's gradient of one
    step moves beyond round-off (|g| at least ``ROUND_OFF_SHARE`` of its own
    leaf's root mean square), or-ed into ``kept`` (the earlier steps'), so
    that an entry a later step first moves, as an embedding row of a token
    that a later batch first holds, is compared. Attention's packed
    ``in_proj_bias`` holds the key bias, whose gradient is nought to
    rounding in every step, beside the query's and the value's; Adam moves
    those entries by lr x sign(noise)."""
    out = []
    for i, g in enumerate(grads):
        rms = g.float().square().mean().sqrt()
        hit = (g.abs() >= ROUND_OFF_SHARE * rms) & (rms > 0)
        out.append(hit if kept is None else kept[i] | hit)
    return out


def touched(grads: Sequence["torch.Tensor"], kept: Sequence["torch.Tensor"] = None) -> list:
    """Per leaf, the entries whose reference gradient is not 0 in one step,
    or-ed into ``kept``."""
    out = [g != 0 for g in grads]
    return out if kept is None else [k | t for k, t in zip(kept, out)]


def left_out(leaves: Sequence[bool], entries: Sequence["torch.Tensor"],
             nonzero: Sequence["torch.Tensor"]) -> str:
    """What the rules leave out of the change: leaves, and entries of all,
    of which how many the reference's gradient never touched (0 in every
    checked step, as the embedding row of a token no batch holds)."""
    total = sum(k.numel() for k in entries)
    kept = sum(int(k.sum()) for k, leaf in zip(entries, leaves) if leaf)
    never = total - sum(int(t.sum()) for t in nonzero)
    return (f"{len(leaves) - sum(leaves)} of {len(leaves)} leaves, "
            f"{total - kept} of {total} entries ({(total - kept) / max(total, 1):.4%}), "
            f"{never} of them with a gradient of 0 in every checked step")


def masked_norms(tensors: Sequence["torch.Tensor"], masks: Sequence["torch.Tensor"]) -> List[float]:
    """Each tensor's norm over its mask's entries."""
    import torch

    return torch.stack([torch.where(k, t.float(), 0.0).norm() for t, k in zip(tensors, masks)]).tolist()


def train_gaps(prog: Dict[str, list], ref: Dict[str, list]) -> Dict[str, tuple]:
    """``loss_gap``: each step's G and D loss; ``grad_gap``: each leaf's
    first gradient as Adam took it; ``change_gap``: each leaf's change over
    the checked steps, in G, D and G_ema, over the leaves and entries that
    the reference's gradient moves in some checked step (``moved``,
    ``moved_entries``). Each as (gap, where): the worst case and the leaves
    that read the most."""
    out = dict(loss_gap=(scalar_gap(prog["losses"], ref["losses"]), "the step losses"))
    keep = {m: ref[f"moved_{m}"] for m in ("G", "D")}
    keep["G_ema"] = keep["G"]
    for what, models in (("grad", ("G", "D")), ("change", ("G", "D", "G_ema"))):
        ranked = []
        for m in models:
            gaps = leaf_gaps(prog[f"{what}_{m}"], ref[f"{what}_{m}"],
                             keep[m] if what == "change" else None)
            names = prog[f"names_{'G' if m == 'G_ema' else m}"]
            ranked += [(g, f"{m}.{names[i]}") for i, g in enumerate(gaps)]
        ranked.sort(reverse=True)
        out[f"{what}_gap"] = (ranked[0][0], ", ".join(f"{n} {g:.3g}" for g, n in ranked[:4]))
    return out
