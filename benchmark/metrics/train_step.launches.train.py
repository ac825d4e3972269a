"""CUDA kernels launched a step in the profiled stretch."""

from benchmark.harness import readers


def read(probe):
    return readers.launches(probe)
