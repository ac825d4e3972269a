"""The train step's share of the fp32 peak: the reference's count of the step's
matmul and conv FLOPs, times the window's steps, over the window's wall time
x 67 TFLOP/s x chips, %."""

from benchmark.harness import readers


def read(probe):
    return readers.mfu(probe)
