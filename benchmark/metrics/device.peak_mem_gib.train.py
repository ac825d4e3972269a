"""torch.cuda.max_memory_allocated() over the window of train steps, GiB."""

from benchmark.harness import readers


def read(probe):
    return readers.peak_gib(probe)
