"""Tracing, the counterpart of ``trace`` in
``layoutdetr_tpu/utils/profiling.py``: ``torch.profiler`` over the
enclosed block, host and (where the run has a card) CUDA activity, written
into ``log_dir`` as a Chrome trace (viewable in Perfetto or
``chrome://tracing``). The bench's ``--profile`` uses it; the train step
and the training loop mark their parts with ``record_function`` ranges,
which the trace shows.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import ProfilerActivity, profile


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
