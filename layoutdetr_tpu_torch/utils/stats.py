"""Named scalar statistics as moment counters.

Counterpart of ``layoutdetr_tpu/utils/stats.py`` (reference
torch_utils/training_stats.py): per-name [n, sum, sum of squares]
accumulators and a ``Collector`` that gives mean and std since the last
``update``. The training loop fetches a group of steps' stats from the
card at once and reports host floats here. With several ranks
(``parallel.distributed``) ``update`` first sums the moments over every
rank (JAX's ``_sync``, layoutdetr_tpu/utils/stats.py:56-66; reference
training_stats.py:232-264), so every rank sees the mean over all of them;
every rank calls it, with the same names.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Mapping

import numpy as np

from layoutdetr_tpu_torch.parallel.distributed import all_reduce_host


class Collector:
    """Accumulates [n, sum x, sum x^2] per name; ``mean``/``std`` give the
    values between the last two ``update`` calls. Non-finite values are
    dropped."""

    def __init__(self, regex: str = ".*"):
        self._regex = re.compile(regex)
        self._moments: Dict[str, np.ndarray] = {}
        self._cumulative: Dict[str, np.ndarray] = {}
        self._deltas: Dict[str, np.ndarray] = {}

    def report(self, name: str, value) -> None:
        """Accumulate a scalar or an array of values under ``name``."""
        if not self._regex.fullmatch(name):
            return
        arr = np.asarray(value, dtype=np.float64).ravel()
        arr = arr[np.isfinite(arr)]
        m = np.array([arr.size, arr.sum(), np.square(arr).sum()], np.float64)
        self._moments[name] = self._moments.get(name, np.zeros(3)) + m

    def report_dict(self, stats: Mapping[str, object]) -> None:
        for k, v in stats.items():
            self.report(k, v)

    def update(self) -> None:
        """Snapshot the deltas since the previous update (training_stats.py:166-183)."""
        self._sync()
        for name, total in self._cumulative.items():
            prev = self._deltas.get(name + "/_prev", np.zeros(3))
            self._deltas[name] = total - prev
            self._deltas[name + "/_prev"] = total.copy()

    def _sync(self) -> None:
        """The pending moments, summed over the ranks, into the totals."""
        names = sorted(self._moments)
        if not names:
            return
        flat = all_reduce_host([v for n in names for v in self._moments[n]])
        for i, name in enumerate(names):
            m = np.array(flat[3 * i:3 * i + 3], np.float64)
            self._cumulative[name] = self._cumulative.get(name, np.zeros(3)) + m
        self._moments = {}

    def names(self) -> Iterable[str]:
        return [n for n in self._deltas if not n.endswith("/_prev")]

    def num(self, name: str) -> int:
        return int(self._deltas.get(name, np.zeros(3))[0])

    def mean(self, name: str) -> float:
        d = self._deltas.get(name, np.zeros(3))
        return float(d[1] / d[0]) if d[0] > 0 else float("nan")

    def std(self, name: str) -> float:
        d = self._deltas.get(name, np.zeros(3))
        if d[0] <= 1:
            return 0.0 if d[0] == 1 else float("nan")
        mean = d[1] / d[0]
        return float(np.sqrt(max(d[2] / d[0] - mean * mean, 0.0)))

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {name: dict(num=self.num(name), mean=self.mean(name), std=self.std(name))
                for name in self.names()}
