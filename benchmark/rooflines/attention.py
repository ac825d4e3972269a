"""The fused attention kernel (``ops/csrc/attention.cu``): softmax(q k^T *
scale + bias) v over [B, H, S, D], in its deterministic and dropout forms.

Operations: q k^T and p v, 2 * B*H*S*S*D each (the softmax's and the
dropout's elementwise work is not counted). Bytes: q, k, v read and the
output written once, plus the fp32 [B, S] key bias; the keep mask is drawn
in-kernel and costs none.
"""

KERNELS = r"attention_fwd_(f32|bf16)_kernel"


def cost(call: dict):
    """(flops, bytes) of one call: ``shape`` [B, H, S, D], ``itemsize``."""
    b, h, s, d = call["shape"]
    es = call["itemsize"]
    return 4.0 * b * h * s * s * d, 4.0 * b * h * s * d * es + 4.0 * b * s
