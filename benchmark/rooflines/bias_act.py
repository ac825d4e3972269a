"""The fused bias + activation kernels (``ops/csrc/bias_act.cu``): the
forward y = clamp(act(x + b) * gain) and the backward, which writes dx and
reduces db per channel in one launch.

Forward: 4 operations an element; x read and y written once, b read once.
Backward: 6 operations an element; dy read, x read where the activation's
derivative or the clamp needs it, dx written unless the call is linear
with gain 1 and no clamp (dx is then dy itself), b read and the fp32 db
written once.
"""

import math

KERNELS = r"\b(fwd|bwd)_(map|fc)<"


def _parts(call: dict):
    n = math.prod(call["shape"])
    return n, call["itemsize"], call["shape"][call["dim"] % len(call["shape"])]


def forward(call: dict):
    n, es, c = _parts(call)
    return 4.0 * n, 2.0 * n * es + es * c


def backward(call: dict):
    n, es, c = _parts(call)
    need_x = call["act"] != "linear" or call["clamp"] is not None
    pass_through = (call["act"] == "linear" and call["gain"] in (None, 1.0)
                    and call["clamp"] is None)
    return 6.0 * n, n * es * (1 + need_x + (not pass_through)) + (es + 4.0) * c
