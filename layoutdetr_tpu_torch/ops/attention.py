"""Fused multi-head attention: a hand-written CUDA kernel for Hopper and
its plain PyTorch version.

Counterpart of ``layoutdetr_tpu/ops/attention.py``. The TPU kernel
(``_attn_kernel``) becomes ``csrc/attention.cu``; the source note there
says how it is blocked and what bounds it on an H100. It carries the
self-attention of the frozen BERT text encoder, forward only: logits
and probabilities never reach device memory.

``fused_attention`` launches the kernel for CUDA tensors and uses
``attention_ref`` only for CPU tensors; there is no fallback from one to
the other. Its ``launches`` attribute counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from layoutdetr_tpu_torch.ops import _build

HEAD_DIM = 192  # the head dim the kernel is built for (768 wide, 4 heads)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def attention_ref(q, k, v, bias, scale):
    """Plain version: q, k, v [B,H,S,D]; bias [B,S] additive (broadcast over
    queries).

    Logits and softmax in fp32; probabilities cast to v's dtype before
    ``p @ v``, as the JAX reference does.
    """
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    logits = logits * scale + bias[:, None, None, :]
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype), v)


@functools.cache
def _lib():
    lib = _build.load("attention")
    fn = lib.layoutdetr_attention_forward
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, bias):
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_attention takes float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be [B,H,S,D] of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, s, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"head dim {d}: the kernel is built for {HEAD_DIM}")
    if bias.dtype != torch.float32 or tuple(bias.shape) != (b, s) or not bias.is_contiguous():
        raise ValueError(f"bias must be a contiguous float32 [{b}, {s}] tensor")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    esize = q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous (stride 1)")
        if t.data_ptr() % 16 or any(st * esize % 16 for st in t.stride()[:3]):
            raise ValueError(f"every row of {name} must start 16-byte aligned")


def fused_attention(q, k, v, bias, *, scale, dropout_rate=0.0):
    """q, k, v: [B,H,S,D]; bias: [B,S] float32 additive key mask.

    Returns [B,H,S,D] in q's dtype, laid out like q. On the card D must be
    192 and the head dim contiguous, with every row 16-byte aligned; the
    other dims may be strided (a [B,S,H,D] projection viewed as [B,H,S,D]
    needs no copy). fp32 runs on the CUDA cores, bf16 on the tensor cores.
    Forward only.

    ``dropout_rate > 0`` (the training form) is not ported yet and raises.
    """
    if dropout_rate > 0.0:
        raise NotImplementedError("fused_attention with dropout is not ported yet")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, bias, scale)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention runs on CUDA or CPU tensors, got {q.device}")
    _check(q, k, v, bias)
    b, h, s, d = q.shape
    out = torch.empty_like(q)
    strides = (ctypes.c_longlong * 12)(*(st for t in (q, k, v, out) for st in t.stride()[:3]))
    with torch.cuda.device(q.device):
        err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
                     ctypes.addressof(strides), b, h, s, d, float(scale), _DTYPE_CODE[q.dtype],
                     torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: cudaError {err}")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0
