"""Operations and bytes of the program's hand-written kernels, one module
per kernel, worked out from each call's shapes: each input byte counted
read once and each output byte written once, as the kernels' own bench
counted them. ``least_seconds`` is a call's least time on the card's
published peaks and which of the two bounds it."""

from benchmark.harness.common import PEAK_BYTES_PER_S, PEAK_FLOPS

PEAK_BY_ITEMSIZE = {4: PEAK_FLOPS["float32"], 2: PEAK_FLOPS["bfloat16"]}


def least_seconds(flops: float, nbytes: float, itemsize: int):
    """(seconds, "operations" or "bytes")."""
    t_ops = flops / PEAK_BY_ITEMSIZE[itemsize]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
