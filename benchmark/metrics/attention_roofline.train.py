"""The fused attention kernel's share of its roofline in the train step (the
hoisted text pass, dropout form), %."""

from benchmark.harness import readers
from benchmark.rooflines import attention


def read(probe):
    calls = [(*attention.cost(c), c["itemsize"]) for c in probe["census"].attention]
    return readers.roofline(probe, "attention", attention.KERNELS, calls)
