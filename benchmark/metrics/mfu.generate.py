"""The serving entry's share of the fp32 peak: the reference's count of G's
matmul and conv FLOPs a request (its layouts in one forward), times the
window's requests, over the window's wall time x 67 TFLOP/s x chips, %."""

from benchmark.harness import readers


def read(probe):
    return readers.mfu(probe)
