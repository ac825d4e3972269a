"""Readers of the program's own spans in a traced run: the card's idle time
while some of them were open, and the kernels they launched.

The spans are the port's ``record_function`` ranges (``generate.*``,
``train_step.*``), stamped on the clock of the device trace. Only the fully
profiled stretch records them, and its host runs slower than the
device-only stretch that ``readers.idle_pct`` reads (up to ~5x the idle in
a ViT train step). So ``idle_ms`` reads the spans' share of the fully
profiled stretch's idle and scales it to the device-only stretch's idle:
the card's own idle, apportioned among the spans as the full profile shows
it. ``idle_ms`` and ``launches`` take the cell driver's probe and a list of
span names and return a figure a step or request, or None where there is
no card or one of the named spans is absent (a program that does not mark
it).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from benchmark.harness import readers
from benchmark.harness.trace import Summary, _merge


def idle_intervals(summary: Summary) -> List[Tuple[int, int]]:
    """The first device's idle intervals within the stretch, in time order
    (the gaps ``Summary.idle_gaps`` sums)."""
    first = min((o.device for o in summary.ops), default=0)
    busy = _merge([(max(o.start, summary.t0), min(o.end, summary.t1)) for o in summary.ops
                   if o.device == first])
    gaps, cursor = [], summary.t0
    for s, e in busy:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if cursor < summary.t1:
        gaps.append((cursor, summary.t1))
    return gaps


def overlap_ns(a: Sequence[Tuple[int, int]], b: Sequence[Tuple[int, int]]) -> int:
    """The length of the intersection of two sorted lists of disjoint intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _marked(probe, names: Sequence[str]) -> Optional[Summary]:
    """The probe's fully profiled stretch, if on a card and it holds every span."""
    if not readers.on_card(probe):
        return None
    summary = probe["summary"]
    return summary if all(n in summary.ranges for n in names) else None


def idle_ms(probe, names: Sequence[str]) -> Optional[float]:
    """The device-only stretch's idle time, ms a step, times the share of the
    fully profiled stretch's idle (first device) that falls while one of the
    spans ``names`` is open on the host."""
    summary = _marked(probe, names)
    if summary is None:
        return None
    idle = idle_intervals(summary)
    total = sum(e - s for s, e in idle)
    if total == 0:
        return 0.0
    within = _merge([iv for n in names for iv in summary.ranges[n]])
    busy_s, window_s = probe["busy"]
    return overlap_ns(idle, within) / total * (window_s - busy_s) * 1e3 / summary.steps


def launches(probe, names: Sequence[str]) -> Optional[float]:
    """Kernels the spans ``names`` launched in the fully profiled stretch (a
    kernel launched inside two of them, or two instances of one, counted
    once), a step."""
    summary = _marked(probe, names)
    if summary is None:
        return None
    return len({id(k) for n in names for k in summary.range_kernels[n]}) / summary.steps
