"""The 95th percentile, over every request the window served, of the host
clock around its ``generate_layouts`` call (the queue's wait left out: in a
cell above capacity the queue grows all through the run), ms."""

from benchmark.harness import readers


def read(probe):
    return readers.service_p95_ms(probe)
