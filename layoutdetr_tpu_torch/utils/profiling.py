"""Tracing, the counterpart of ``trace`` in
``layoutdetr_tpu/utils/profiling.py``: ``torch.profiler`` over the
enclosed block, host and (where the run has a card) CUDA activity, written
into ``log_dir`` as a Chrome trace (viewable in Perfetto or
``chrome://tracing``). The bench's ``--profile`` uses it.

The train step and the serving entries mark their parts with ``span``:
a ``record_function`` range while a torch profiler records, and one flag
check otherwise (a ``record_function`` outside a profiler still makes a
dispatcher call, ~12 us on a CPU host). Span names carry a dot and neither a
space nor ``::`` (``train_step.Dmain``, ``generate.upload``), the form that
tells a range from an ATen operation (``aten::mm``) or an autograd node
(``AddmmBackward0``) in a trace. The profiler stamps a span's host interval
and the device's activity on one clock, the host's wall clock
(CLOCK_REALTIME, as ``time.time_ns()``), so the card's idle time can be
laid against the spans that were open.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import ProfilerActivity, profile, record_function

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that marks the enclosed block as the range ``name``
    in a profile; a shared no-op when no profiler is recording."""
    if torch._C._autograd._profiler_enabled():
        return record_function(name)
    return _OFF


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    """Profile the enclosed block; write ``<log_dir>/trace_<pid>.json``
    (Chrome trace format). CUDA activity is recorded when a card is
    present."""
    if not enabled:
        yield None
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))
