"""The traced stretch: a short, fixed run of steady steps or batches under
``torch.profiler``, reduced in memory to what the per-layer metrics read.

Kept from the profile (the whole trace is never written out):

- every device operation (kernel, memcpy, memset) with its interval;
- the host intervals of every ``record_function`` range, the program's
  (``train_step.*``) and the benchmark's own (``bench.*``), and the kernels
  each range launched (those whose launch call the host made while the
  range was open), whose busy time is the range's device time;
- the host's ATen operations, to say what the host was doing while the
  device sat idle.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import re
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from benchmark.harness.common import log

STRETCH = "bench.stretch"
_DEVICE_KINDS = {"kernel", "gpu_memcpy", "gpu_memset"}
_LAUNCH = re.compile(r"^(cudaLaunchKernel|cudaLaunchKernelExC|cuLaunchKernel|cuLaunchKernelEx|"
                     r"cudaLaunchCooperativeKernel)")


@dataclasses.dataclass
class DeviceOp:
    name: str
    kind: str  # kernel, gpu_memcpy or gpu_memset
    start: int  # ns
    end: int
    device: int


@dataclasses.dataclass
class Summary:
    steps: int  # steps or batches in the stretch
    window_s: float  # the stretch on the host clock
    ops: List[DeviceOp]
    ranges: Dict[str, List[Tuple[int, int]]]  # host intervals by name
    range_kernels: Dict[str, List[DeviceOp]]  # kernels each range launched, by name
    host_ops: List[Tuple[int, int, str]]  # outermost ATen ops (start, end, name)
    launches: int  # kernel launch calls on the host
    t0: int  # the stretch's host interval, ns
    t1: int

    def kernels(self, pattern: Optional[str] = None) -> List[DeviceOp]:
        rx = re.compile(pattern) if pattern else None
        return [o for o in self.ops if o.kind == "kernel" and (rx is None or rx.search(o.name))]

    def device_ms(self, name: str) -> Optional[float]:
        """Device busy time of the kernels range ``name`` launched, over all
        its instances, in ms (None if it launched none)."""
        kernels = self.range_kernels.get(name)
        if not kernels:
            return None
        return _union_ns([(k.start, k.end) for k in kernels]) / 1e6

    def top_ops(self, n: int = 10) -> List[list]:
        by = collections.Counter()
        for o in self.ops:
            by[_short(o.name)] += (o.end - o.start) / 1e9
        return [[k, v] for k, v in by.most_common(n)]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The device's idle time within the stretch, summed by what the
        host was doing when each gap began (innermost range / outermost
        ATen op); the ``n`` largest."""
        first = min((o.device for o in self.ops), default=0)
        merged = _merge([(max(o.start, self.t0), min(o.end, self.t1)) for o in self.ops
                         if o.device == first])
        gaps, cursor = [], self.t0
        for s, e in merged:
            if s > cursor:
                gaps.append((cursor, s))
            cursor = max(cursor, e)
        if cursor < self.t1:
            gaps.append((cursor, self.t1))
        starts = [h[0] for h in self.host_ops]
        flat = sorted((s, e, name) for name, ivs in self.ranges.items() for s, e in ivs
                      if name != STRETCH)
        by = collections.Counter()
        active, i = [], 0
        for s, e in gaps:  # in time order: sweep the ranges open at each gap's start
            while i < len(flat) and flat[i][0] <= s:
                active.append(flat[i])
                i += 1
            active = [r for r in active if r[1] >= s]
            inner = max(active, default=None)  # the latest start: the innermost range
            j = bisect.bisect_right(starts, s) - 1
            op = self.host_ops[j][2] if j >= 0 and self.host_ops[j][1] >= s else "python"
            by[f"{inner[2] if inner else 'outside ranges'} / {op}"] += (e - s) / 1e9
        return [[k, v] for k, v in by.most_common(n)]


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _union_ns(intervals) -> int:
    return sum(e - s for s, e in _merge(intervals))


def _short(name: str, width: int = 120) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."


def profile(step: Callable[[], None], steps: int, sync: Callable[[], None]) -> Summary:
    """Run ``step`` ``steps`` times under the profiler, between two
    synchronizations, inside the range ``bench.stretch``; reduce the trace."""
    from torch.profiler import ProfilerActivity, record_function

    sync()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(STRETCH):
            sync()
            for _ in range(steps):
                step()
            sync()
    summary = reduce(prof.profiler.kineto_results.events(), steps)
    log(f"profiled {steps} steps: {len(summary.ops)} device ops, {summary.launches} launch calls, "
        f"ranges {sorted(summary.ranges)}")
    return summary


_RUNTIME = re.compile(r"^(cuda|cu[A-Z]|nccl)")
_RANGE = re.compile(r"^(?!.*::)[^ ]*[.#][^ ]*$")


def _host_names(events) -> set:
    return {ev.name() for ev in events if ev.device_type() == torch.autograd.DeviceType.CPU}


def _end_ns(ev) -> int:
    return ev.start_ns() + ev.duration_ns()


def _device_index(ev) -> int:
    return ev.device_index() if hasattr(ev, "device_index") else 0


def _kind(ev, host_names) -> str:
    """The event's activity: kernel, gpu_memcpy, gpu_memset,
    gpu_user_annotation, user_annotation, runtime or cpu_op. Taken from
    ``activity_type`` where the profiler gives it, else from the device and
    the name: a device event named as a host event is a range's device-side
    annotation; on the host, a ``record_function`` range is named like
    ``bench.feed``, ``train_step.Dmain`` or ``Optimizer.step#Adam.step`` (a
    dot or a hash, no ``::`` and no space), which ATen operations
    (``aten::mm``), autograd nodes (``AddmmBackward0``) and the profiler's
    own events (``Activity Buffer Request``) are not."""
    if hasattr(ev, "activity_type"):
        kind = ev.activity_type()
        return "runtime" if kind in ("cuda_runtime", "cuda_driver") else kind
    name = ev.name()
    if ev.device_type() != torch.autograd.DeviceType.CPU:
        if name in host_names:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if _RUNTIME.match(name):
        return "runtime"
    return "user_annotation" if _RANGE.match(name) else "cpu_op"


def device_busy(step: Callable[[], None], steps: int, sync: Callable[[], None]):
    """(busy_s, window_s) of ``steps`` steps traced with the device activity
    alone: the union of device operations over the devices' mean, and the
    host clock between two synchronizations. Without the host's operator
    events the profiler adds little to a step, so the idle share is the
    pipeline's own (under the full profile a step of ~20,000 launches runs
    ~1.7x slower)."""
    from torch.profiler import ProfilerActivity

    if not torch.cuda.is_available():  # the harness's own tests
        return 0.0, 0.0
    sync()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        sync()
        window_s = time.perf_counter() - t0
    per_dev = collections.defaultdict(list)
    events = list(prof.profiler.kineto_results.events())
    host_names = _host_names(events)
    for ev in events:
        if _kind(ev, host_names) in _DEVICE_KINDS:
            per_dev[_device_index(ev)].append((ev.start_ns(), _end_ns(ev)))
    busy_s = sum(_union_ns(iv) for iv in per_dev.values()) / 1e9 / max(len(per_dev), 1)
    log(f"device-only trace of {steps} steps: busy {busy_s:.4f} s of {window_s:.4f} s")
    return busy_s, window_s


def reduce(events, steps: int) -> Summary:
    all_ops: List[DeviceOp] = []
    ranges: Dict[str, list] = collections.defaultdict(list)
    cpu_ops: list = []
    launch_at: Dict[int, int] = {}
    kernel_of: Dict[int, DeviceOp] = {}
    events = list(events)
    host_names = _host_names(events)
    for ev in events:
        kind = _kind(ev, host_names)
        if kind in _DEVICE_KINDS:
            op = DeviceOp(ev.name(), kind, ev.start_ns(), _end_ns(ev), _device_index(ev))
            all_ops.append(op)
            if kind == "kernel":
                kernel_of[ev.correlation_id()] = op
        elif kind == "user_annotation":
            ranges[ev.name()].append((ev.start_ns(), _end_ns(ev)))
        elif kind == "cpu_op":
            cpu_ops.append((ev.start_ns(), _end_ns(ev), ev.name()))
        elif kind == "runtime" and _LAUNCH.match(ev.name()):
            launch_at[ev.correlation_id()] = ev.start_ns()
    if STRETCH not in ranges:
        raise RuntimeError("the profile holds no stretch range: the profiler recorded nothing")
    t0, t1 = ranges[STRETCH][0]
    ops = [o for o in all_ops if o.end > t0 and o.start < t1]
    cpu_ops.sort()
    outer, last_end = [], -1
    for s, e, name in cpu_ops:
        if s >= last_end:
            outer.append((s, e, name))
            last_end = e
    launched = sorted(((launch_at[c], op) for c, op in kernel_of.items() if c in launch_at),
                      key=lambda x: x[0])
    keys = [t for t, _ in launched]
    range_kernels: Dict[str, list] = {}
    for name, ivs in ranges.items():
        range_kernels[name] = [op for s, e in ivs for _, op in
                               launched[bisect.bisect_left(keys, s):bisect.bisect_right(keys, e)]]
    return Summary(steps, (t1 - t0) / 1e9, ops, dict(ranges), range_kernels, outer,
                   len(launch_at), t0, t1)
