"""What the per-layer metrics' readers share. Each reader takes the
cell driver's probe of a traced run (``summary``: the profiled stretch; ``census``:
the reference's count at the cell's shapes; the window's wall time and
steps; ``peak_bytes``; ``chips``) and returns a number, or None where it
finds nothing to read: no card, no such range, or kernel launches that do
not match the calls the census expects."""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

from benchmark.harness.common import PEAK_FLOPS, log
from benchmark.rooflines import least_seconds


def on_card(probe) -> bool:
    return bool(probe and probe["summary"].ops)


def mfu(probe) -> Optional[float]:
    """The window's matmul and conv FLOPs (the census's count a step or
    batch, times the steps) over its wall time x the fp32 peak x chips, %."""
    if not on_card(probe):
        return None
    flops = probe["census"].flops * probe["window_steps"]
    return 100.0 * flops / (probe["window_s"] * PEAK_FLOPS["float32"] * probe["chips"])


def range_ms(probe, names: Sequence[str]) -> Optional[float]:
    """Device time of the kernels ranges ``names`` launch, ms a step (None if
    one launched none)."""
    if not on_card(probe):
        return None
    times = [probe["summary"].device_ms(n) for n in names]
    if any(t is None for t in times):
        return None
    return sum(times) / probe["summary"].steps


def roofline(probe, name: str, pattern: str,
             calls: List[tuple]) -> Optional[float]:
    """Least time over measured time of the kernels matching ``pattern``, %.
    ``calls``: (flops, bytes, itemsize) of every launch one step makes."""
    if not on_card(probe):
        return None
    summary = probe["summary"]
    kernels = summary.kernels(pattern)
    expected = len(calls) * summary.steps
    if not kernels or len(kernels) != expected:
        log(f"{name}: {len(kernels)} launches traced, {expected} expected: not read")
        return None
    bounds = [least_seconds(f, b, es) for f, b, es in calls]
    least = sum(t for t, _ in bounds) * summary.steps
    measured = sum(k.end - k.start for k in kernels) / 1e9
    by_ops = sum(t for t, by in bounds if by == "operations")
    log(f"{name}: least {least * 1e3:.4f} ms ({by_ops / max(least / summary.steps, 1e-30):.0%} "
        f"of it bound by operations, the rest by bytes) over {measured * 1e3:.4f} ms measured, "
        f"{len(kernels)} launches")
    return 100.0 * least / measured


def idle_pct(probe) -> Optional[float]:
    """1 - device busy / wall of the device-only traced stretch, %."""
    if not on_card(probe):
        return None
    busy_s, window_s = probe["busy"]
    return 100.0 * (1.0 - busy_s / window_s)


def peak_gib(probe) -> Optional[float]:
    if not on_card(probe):
        return None
    return probe["peak_bytes"] / 2 ** 30


def launches(probe) -> Optional[float]:
    if not on_card(probe):
        return None
    s = probe["summary"]
    return len(s.kernels()) / s.steps


def p95(values: Sequence[float]) -> float:
    """The nearest-rank 95th percentile."""
    s = sorted(values)
    return s[max(math.ceil(0.95 * len(s)) - 1, 0)]


def service_p95_ms(probe) -> Optional[float]:
    """The 95th percentile of the window's service times, ms."""
    if not on_card(probe):
        return None
    return 1e3 * p95(probe["service_s"])
