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
the other. ``LAUNCHES`` counts kernel launches by form:
``"fused_attention"`` the deterministic ones, ``"fused_attention_dropout"``
those with dropout.

The host path is kept light: a ``Plan`` per call signature (shapes,
strides and dtypes of q, k, v, the output and the bias, scale, rate) is
built once and cached. It holds the checked geometry, the bf16 body's
tensor-map geometry (``map_geometry``: dims and byte strides of each map)
and the kernel's scalars in a ctypes Structure that the C entry point
takes by pointer. Per call only the device and the 16-byte alignment of
the pointers are checked, the output is allocated, the stream is read
with ``torch._C._cuda_getCurrentRawStream`` and, for bf16, the C side
encodes the four tensor maps (they hold the pointers).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

import torch

from layoutdetr_tpu_torch.ops import _build

HEAD_DIM = 192  # the head dim the kernel is built for (768 wide, 4 heads)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# kernel launches by form, counted where they happen
LAUNCHES = {"fused_attention": 0, "fused_attention_dropout": 0}

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


def keep_mask(seed: int, batch: int, heads: int, seq: int, rate: float, device=None,
              head_offset: int = 0, total_heads=None):
    """[batch, heads, seq, seq] bool keep mask of the dropout form, the
    bits ``attention.cu`` draws: key (seed, b*H + head_offset + h), counter
    (k // 4, q, 0, 0), word k % 4, where H = ``total_heads`` (default
    ``heads``). A tensor-parallel rank that holds heads [head_offset,
    head_offset + heads) of H draws the same bits as a pass over all H."""
    total_heads = heads if total_heads is None else total_heads
    groups = (seq + 3) // 4
    bh = (torch.arange(batch, device=device).view(batch, 1, 1, 1) * total_heads + head_offset
          + torch.arange(heads, device=device).view(1, heads, 1, 1))
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


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

class _MapGeom(ctypes.Structure):
    """struct MapGeom of attention.cu, field for field."""
    _fields_ = [("dims", ctypes.c_uint64 * 4), ("strides", ctypes.c_uint64 * 3),
                ("pos_h", ctypes.c_int), ("pos_t", ctypes.c_int), ("pos_b", ctypes.c_int),
                ("pad_", ctypes.c_int)]


class _Params(ctypes.Structure):
    """struct Params of attention.cu, field for field."""
    _fields_ = [("dtype", ctypes.c_int), ("batch", ctypes.c_int), ("heads", ctypes.c_int),
                ("seq", ctypes.c_int), ("head_dim", ctypes.c_int), ("scale", ctypes.c_float),
                ("dropout", ctypes.c_int), ("threshold", ctypes.c_uint),
                ("inv_keep", ctypes.c_float), ("head_offset", ctypes.c_int),
                ("total_heads", ctypes.c_int), ("pad_", ctypes.c_int),
                ("strides", ctypes.c_longlong * 12), ("maps", _MapGeom * 4)]


class Spec(NamedTuple):
    """What a plan needs of one tensor: shape, strides (elements), dtype."""
    shape: tuple
    stride: tuple
    dtype: torch.dtype

    @classmethod
    def of(cls, t: torch.Tensor) -> "Spec":
        return cls(tuple(t.shape), t.stride(), t.dtype)


@dataclasses.dataclass(frozen=True)
class MapGeometry:
    """The TMA map of one of q, k, v, o (bf16 body): ``dims`` in elements,
    the head dim first and then head, sequence and batch in order of
    increasing stride; ``strides`` the byte strides of dims 1-3; ``pos``
    the map dims (1-3) of (head, sequence, batch)."""
    dims: tuple
    strides: tuple
    pos: tuple


def map_geometry(spec: Spec) -> MapGeometry:
    """The 4-d TMA map over a [B, H, T, D] view with D contiguous. A dim of
    size 1 is never stepped: it goes last, with a stride past the others."""
    b, h, t, d = spec.shape
    esize = spec.dtype.itemsize
    sizes = dict(h=h, t=t, b=b)
    byte = dict(h=spec.stride[1] * esize, t=spec.stride[2] * esize, b=spec.stride[0] * esize)
    real = sorted((n for n in "htb" if sizes[n] > 1), key=lambda n: byte[n])
    extent = max([byte[n] * sizes[n] for n in real] + [d * esize])
    order = real + [n for n in "htb" if sizes[n] == 1]
    for n in order[len(real):]:
        byte[n] = extent
    return MapGeometry((d, *(sizes[n] for n in order)), tuple(byte[n] for n in order),
                       tuple(order.index(n) + 1 for n in "htb"))


@dataclasses.dataclass(frozen=True)
class Plan:
    """Everything about a call that its signature fixes: the body, the
    bf16 body's maps of q, k, v, o, and the ``_Params`` the C entry point
    takes by pointer (``addr``, kept alive by ``params``)."""
    body: str  # "fp32" or "bf16"
    maps: tuple  # MapGeometry of q, k, v, o (bf16), else ()
    params: _Params = dataclasses.field(compare=False, repr=False)
    addr: int = dataclasses.field(compare=False, repr=False)


def make_plan(q: Spec, k: Spec, v: Spec, o: Spec, bias: Spec, scale: float,
              dropout_rate: float, head_offset: int = 0, total_heads=None) -> Plan:
    """The plan of one call signature; raises on what the kernels do not take."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_attention takes float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype or o.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if len(q.shape) != 4 or k.shape != q.shape or v.shape != q.shape or o.shape != q.shape:
        raise ValueError(f"q, k, v must be [B,H,S,D] of one shape, got {q.shape}, {k.shape}, "
                         f"{v.shape}")
    b, h, s, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"head dim {d}: the kernel is built for {HEAD_DIM}")
    if min(b, h, s) < 1:
        raise ValueError("fused_attention's kernels take no empty tensor")
    total_heads = h if total_heads is None else total_heads
    if head_offset < 0 or total_heads < head_offset + h:
        raise ValueError(f"heads [{head_offset}, {head_offset + h}) do not lie in {total_heads}")
    if bias.dtype != torch.float32 or bias.shape != (b, s) or (s > 1 and bias.stride[1] != 1) or (
            b > 1 and bias.stride[0] != s):
        raise ValueError(f"bias must be a contiguous float32 [{b}, {s}] tensor")
    esize = q.dtype.itemsize
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o)):
        if t.stride[3] != 1:
            raise ValueError(f"{name}'s head dim must be contiguous (stride 1)")
        if any(st * esize % 16 for st, n in zip(t.stride[:3], t.shape[:3]) if n > 1):
            raise ValueError(f"every row of {name} must start 16-byte aligned: byte strides "
                             f"{[st * esize for st in t.stride[:3]]}")
    bf16 = q.dtype == torch.bfloat16
    maps = tuple(map_geometry(t) for t in (q, k, v, o)) if bf16 else ()
    params = _Params(dtype=_DTYPE_CODE[q.dtype], batch=b, heads=h, seq=s, head_dim=d,
                     scale=scale, dropout=int(dropout_rate > 0.0),
                     threshold=dropout_threshold(dropout_rate),
                     inv_keep=1.0 / (1.0 - dropout_rate), head_offset=head_offset,
                     total_heads=total_heads,
                     strides=(ctypes.c_longlong * 12)(*(st for t in (q, k, v, o)
                                                        for st in t.stride[:3])))
    for geom, m in zip(params.maps, maps):
        geom.dims[:] = m.dims
        geom.strides[:] = m.strides
        geom.pos_h, geom.pos_t, geom.pos_b = m.pos
    return Plan("bf16" if bf16 else "fp32", maps, params, ctypes.addressof(params))


_plans: dict = {}


def _check(q, k, v, bias, out=None, scale: float = 1.0, dropout_rate: float = 0.0,
           head_offset: int = 0, total_heads=None) -> Plan:
    """The cached plan of this call (``out`` defaults to ``empty_like(q)``'s
    layout), after the checks a call needs: one device, every pointer
    16-byte aligned. Raises on whatever the kernels do not take."""
    if out is None:
        out = torch.empty_like(q)
    key = (q.shape, q.stride(), q.dtype, k.shape, k.stride(), k.dtype, v.shape, v.stride(),
           v.dtype, out.stride(), bias.shape, bias.stride(), bias.dtype, scale, dropout_rate,
           head_offset, total_heads)
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = make_plan(Spec.of(q), Spec.of(k), Spec.of(v), Spec.of(out),
                                       Spec.of(bias), scale, dropout_rate, head_offset,
                                       total_heads)
    dev = q.get_device()
    if k.get_device() != dev or v.get_device() != dev or bias.get_device() != dev:
        raise ValueError("q, k, v and bias must lie on one device")
    if (q.data_ptr() | k.data_ptr() | v.data_ptr() | out.data_ptr()) % 16:
        raise ValueError("q, k, v must start 16-byte aligned")
    return plan


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

@functools.cache
def _lib():
    lib = _build.load("attention")
    size = lib.layoutdetr_attention_params_size()
    if size != ctypes.sizeof(_Params):
        raise RuntimeError(f"attention.cu's Params is {size} bytes, _Params {ctypes.sizeof(_Params)}")
    fn = lib.layoutdetr_attention_forward
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_uint, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    enc = lib.layoutdetr_attention_encode_maps
    enc.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int]
    enc.restype = ctypes.c_int
    return fn, enc, torch._C._cuda_getCurrentRawStream


def fused_attention(q, k, v, bias, *, scale, dropout_rate=0.0, seed=None, head_offset=0,
                    total_heads=None):
    """q, k, v: [B,H,S,D]; bias: [B,S] float32 additive key mask.

    Returns [B,H,S,D] in q's dtype, laid out like q. On the card D must be
    192 and the head dim contiguous, with every row 16-byte aligned; the
    other dims may be strided (a [B,S,H,D] projection viewed as [B,H,S,D]
    needs no copy). fp32 runs on the CUDA cores, bf16 on the tensor cores.
    Forward only.

    ``dropout_rate`` in (0, 1) drops probabilities out with the Philox keep
    mask keyed by ``seed`` (an int, required then); see ``keep_mask``.
    ``head_offset`` and ``total_heads`` place q's heads among a layer's
    heads (a tensor-parallel rank's share) in the mask's key.
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
            mask = keep_mask(seed, b, h, s, dropout_rate, head_offset=head_offset,
                             total_heads=total_heads)
        return attention_ref(q, k, v, bias, scale, dropout_rate, mask)
    if not q.is_cuda:
        raise ValueError(f"fused_attention runs on CUDA or CPU tensors, got {q.device}")
    out = torch.empty_like(q)
    plan = _check(q, k, v, bias, out, float(scale), float(dropout_rate), head_offset,
                  total_heads)
    fn, _, stream = _lib()
    dev = q.get_device()
    err = fn(plan.addr, q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
             seed, dev, stream(dev))
    if err != 0:
        raise RuntimeError(f"attention kernel ({plan.body}) launch failed: cudaError {err}")
    LAUNCHES["fused_attention_dropout" if dropout_rate > 0.0 else "fused_attention"] += 1
    return out
