"""Fused multi-head attention: a hand-written CUDA kernel for Hopper and
its plain PyTorch version.

Counterpart of ``layoutdetr_tpu/ops/attention.py``. The TPU kernel
(``_attn_kernel``) becomes ``csrc/attention.cu``; the source note there
says how it is blocked and what bounds it on an H100. It carries the
self-attention of the frozen BERT text encoder, forward only: logits
and probabilities never reach device memory. In the train step's hoisted
text pass it also drops probabilities out (``dropout_rate``, ``seed``).
The TPU kernel's PRNG bits cannot be reproduced off the TPU, so both the
CUDA kernel and the plain path here draw the keep mask from one
counter-based generator, Philox4x32-10 (``philox4x32``, ``keep_mask``):
key (seed, b*H + h), counter (k // 4, q, 0, 0), word k % 4, keep when the
word is >= rate * 2^32. The card and its plain version therefore drop the
same entries.

``fused_attention`` launches the kernel for CUDA tensors and uses
``attention_ref`` only for CPU tensors; there is no fallback from one to
the other. ``LAUNCHES["fused_attention"]`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from layoutdetr_tpu_torch.ops import _build

HEAD_DIM = 192  # the head dim the kernel is built for (768 wide, 4 heads)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
LAUNCHES = {"fused_attention": 0}  # kernel launches, counted where they happen

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit halves of a * m, for a in [0, 2^32) held in int64.
    m is split in 16-bit halves so that no product leaves int64."""
    p_lo = a * (m & 0xFFFF)  # < 2^48
    p_hi = a * (m >> 16)  # < 2^48
    s = p_lo + ((p_hi & 0xFFFF) << 16)  # < 2^49
    return ((s >> 32) + (p_hi >> 16)) & _MASK32, s & _MASK32


def philox4x32(counter, key, rounds: int = 10):
    """Philox4x32-``rounds`` (Random123) in plain tensor ops: uint32 words
    carried in int64 tensors (or ints) that broadcast together. ``counter``
    is 4 words, ``key`` 2; returns the 4 output words."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = (torch.as_tensor(k, dtype=torch.int64) for k in key)
    for r in range(rounds):
        if r > 0:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_threshold(rate: float) -> int:
    """Keep an entry when its 32 random bits are >= this (the TPU kernel's
    ``uint32(rate * 2^32)``)."""
    return int(rate * 4294967296.0)


def keep_mask(seed: int, batch: int, heads: int, seq: int, rate: float, device=None):
    """[batch, heads, seq, seq] bool keep mask of the dropout form, the
    bits ``attention.cu`` draws: key (seed, b*heads + h), counter
    (k // 4, q, 0, 0), word k % 4."""
    groups = (seq + 3) // 4
    bh = torch.arange(batch * heads, device=device).view(batch, heads, 1, 1)
    q = torch.arange(seq, device=device).view(1, 1, seq, 1)
    grp = torch.arange(groups, device=device).view(1, 1, 1, groups)
    words = philox4x32((grp, q, 0, 0), (seed & _MASK32, bh))
    bits = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    bits = bits.reshape(batch, heads, seq, groups * 4)[..., :seq]
    return bits >= dropout_threshold(rate)


def attention_ref(q, k, v, bias, scale, dropout_rate=0.0, keep_mask=None):
    """Plain version: q, k, v [B,H,S,D]; bias [B,S] additive (broadcast over
    queries); optional keep_mask [B,H,S,S] for dropout at ``dropout_rate``.

    Logits and softmax in fp32; probabilities cast to v's dtype before
    ``p @ v``, as the JAX reference does.
    """
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    logits = logits * scale + bias[:, None, None, :]
    p = torch.softmax(logits, dim=-1)
    if dropout_rate > 0.0 and keep_mask is not None:
        p = torch.where(keep_mask, p / (1.0 - dropout_rate), 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype), v)


@functools.cache
def _lib():
    lib = _build.load("attention")
    fn = lib.layoutdetr_attention_forward
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_uint, ctypes.c_uint, ctypes.c_int,
        ctypes.c_void_p]
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


def fused_attention(q, k, v, bias, *, scale, dropout_rate=0.0, seed=None):
    """q, k, v: [B,H,S,D]; bias: [B,S] float32 additive key mask.

    Returns [B,H,S,D] in q's dtype, laid out like q. On the card D must be
    192 and the head dim contiguous, with every row 16-byte aligned; the
    other dims may be strided (a [B,S,H,D] projection viewed as [B,H,S,D]
    needs no copy). fp32 runs on the CUDA cores, bf16 on the tensor cores.
    Forward only.

    ``dropout_rate`` in (0, 1) drops probabilities out with the Philox keep
    mask keyed by ``seed`` (an int, required then); see ``keep_mask``.
    """
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must lie in [0, 1), got {dropout_rate}")
    if dropout_rate > 0.0 and seed is None:
        raise ValueError("fused_attention with dropout needs a seed")
    seed = 0 if seed is None else int(seed) & _MASK32
    if q.device.type == "cpu":
        mask = None
        if dropout_rate > 0.0:
            b, h, s, _ = q.shape
            mask = keep_mask(seed, b, h, s, dropout_rate)
        return attention_ref(q, k, v, bias, scale, dropout_rate, mask)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention runs on CUDA or CPU tensors, got {q.device}")
    _check(q, k, v, bias)
    b, h, s, d = q.shape
    out = torch.empty_like(q)
    strides = (ctypes.c_longlong * 12)(*(st for t in (q, k, v, out) for st in t.stride()[:3]))
    with torch.cuda.device(q.device):
        err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
                     ctypes.addressof(strides), b, h, s, d, float(scale), float(dropout_rate), seed,
                     dropout_threshold(dropout_rate), _DTYPE_CODE[q.dtype],
                     torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: cudaError {err}")
    LAUNCHES["fused_attention"] += 1
    return out
