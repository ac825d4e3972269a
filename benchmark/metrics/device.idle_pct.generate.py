"""The card's idle share while it serves: 1 - device busy time / wall time of a
stretch of requests traced with the device activity alone, %."""

from benchmark.harness import readers


def read(probe):
    return readers.idle_pct(probe)
