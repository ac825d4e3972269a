"""stdout tee and the stats sinks of a training run.

Counterpart of ``layoutdetr_tpu/utils/logging.py`` (reference
dnnlib/util.py:57-120 and training_loop.py:441-452): ``Logger`` tees
stdout and stderr to ``log.txt``, ``StatsJsonlWriter`` appends one JSON
line a tick, ``TensorboardWriter`` writes scalars when TensorBoard is
importable and does nothing otherwise.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Optional


class Logger:
    """Tee stdout/stderr to a file until ``close`` (dnnlib/util.py:57-120)."""

    def __init__(self, file_name: Optional[str] = None, should_flush: bool = True):
        self.file = open(file_name, "a") if file_name else None
        self.should_flush = should_flush
        self.stdout = sys.stdout
        self.stderr = sys.stderr
        sys.stdout = self
        sys.stderr = self

    def write(self, text: str) -> None:
        if len(text) == 0:
            return
        if self.file is not None:
            self.file.write(text)
        self.stdout.write(text)
        if self.should_flush:
            self.flush()

    def flush(self) -> None:
        if self.file is not None:
            self.file.flush()
        self.stdout.flush()

    def close(self) -> None:
        if self.file is not None:
            self.file.close()
            self.file = None
        sys.stdout = self.stdout
        sys.stderr = self.stderr

    def isatty(self):
        return False


class StatsJsonlWriter:
    """Append one JSON line of {name: {num, mean, std}} (and ``extra``) a tick."""

    def __init__(self, path: str):
        self.path = path

    def write(self, stats_dict: dict, extra: Optional[dict] = None) -> None:
        record = dict(stats_dict)
        record["timestamp"] = time.time()
        if extra:
            record.update(extra)
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")


class TensorboardWriter:
    """TensorBoard scalars; a no-op when no SummaryWriter can be imported."""

    def __init__(self, log_dir: str):
        self._writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self._writer = SummaryWriter(log_dir=log_dir)

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalar(tag, value, step)

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
