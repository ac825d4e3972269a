"""Fused bias + activation + gain + clamp: a hand-written CUDA kernel for
Hopper, forward and backward, and its plain PyTorch version.

Counterpart of ``layoutdetr_tpu/ops/bias_act.py``. The TPU kernel
(``_bias_act_pallas``, body ``_bias_act_kernel``) becomes
``csrc/bias_act.cu``; its source note says how it is laid out and what
bounds it on an H100. ``y = clamp(act(x + b[c]) * gain, ±clamp)`` is
computed in fp32 and stored in x's dtype, for the 9 activations of
``activation_funcs`` with their default alpha and gain (reference
bias_act.py:22-32).

``bias_act`` is a ``torch.autograd.Function``: its forward launches
``bias_act_forward`` and its backward ``bias_act_backward`` (dx and a
deterministic per-channel db, recomputing ``x + b`` from x and b) for
CUDA tensors, and the plain versions ``bias_act_ref`` /
``bias_act_ref_backward`` for CPU tensors; there is no fallback from one
to the other. Double backward (the R1 penalty) is out of scope and
raises. ``LAUNCHES["forward"]`` and ``LAUNCHES["backward"]`` count the
wrappers' kernel launches (one per call; the backward's call runs its dx
pass and its db pass).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from layoutdetr_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
LAUNCHES = {"forward": 0, "backward": 0}  # kernel launches, counted where they happen
_SELU_SCALE = 1.0507009873554804934193349852946
_SELU_ALPHA = 1.6732632423543772848170429916717


@dataclasses.dataclass(frozen=True)
class ActSpec:
    code: int  # the kernel's enum Act
    def_alpha: float
    def_gain: float


activation_funcs = {
    "linear": ActSpec(0, 0.0, 1.0),
    "relu": ActSpec(1, 0.0, math.sqrt(2)),
    "lrelu": ActSpec(2, 0.2, math.sqrt(2)),
    "tanh": ActSpec(3, 0.0, 1.0),
    "sigmoid": ActSpec(4, 0.0, 1.0),
    "elu": ActSpec(5, 0.0, 1.0),
    "selu": ActSpec(6, 0.0, 1.0),
    "softplus": ActSpec(7, 0.0, 1.0),
    "swish": ActSpec(8, 0.0, math.sqrt(2)),
}


def _act(z: torch.Tensor, act: str, alpha: float) -> torch.Tensor:
    if act == "linear":
        return z
    if act == "relu":
        return torch.clamp(z, min=0.0)
    if act == "lrelu":
        return torch.where(z >= 0, z, z * alpha)
    if act == "tanh":
        return torch.tanh(z)
    if act == "sigmoid":
        return torch.sigmoid(z)
    if act == "elu":
        return torch.where(z >= 0, z, torch.expm1(z))
    if act == "selu":
        return _SELU_SCALE * torch.where(z >= 0, z, _SELU_ALPHA * torch.expm1(z))
    if act == "softplus":
        return torch.clamp(z, min=0.0) + torch.log1p(torch.exp(-z.abs()))
    if act == "swish":
        return z * torch.sigmoid(z)
    raise ValueError(f"unknown activation {act!r}")


def _act_grad(z: torch.Tensor, act: str, alpha: float) -> torch.Tensor:
    one = torch.ones_like(z)
    if act == "linear":
        return one
    if act == "relu":
        return (z > 0).to(z.dtype)
    if act == "lrelu":
        return torch.where(z >= 0, one, alpha)
    if act == "tanh":
        return 1.0 - torch.tanh(z) ** 2
    if act in ("sigmoid", "softplus"):
        s = torch.sigmoid(z)
        return s * (1.0 - s) if act == "sigmoid" else s
    if act == "elu":
        return torch.where(z >= 0, one, torch.exp(z))
    if act == "selu":
        return _SELU_SCALE * torch.where(z >= 0, one, _SELU_ALPHA * torch.exp(z))
    if act == "swish":
        s = torch.sigmoid(z)
        return s + z * s * (1.0 - s)
    raise ValueError(f"unknown activation {act!r}")


def _resolve(act: str, alpha, gain):
    spec = activation_funcs[act]
    return (float(spec.def_alpha if alpha is None else alpha),
            float(spec.def_gain if gain is None else gain))


def _compute_dtype(x):
    return torch.promote_types(x.dtype, torch.float32)


def _bias_view(b, x, dim):
    shape = [1] * x.dim()
    shape[dim] = -1
    return b.to(_compute_dtype(x)).reshape(shape)


def bias_act_ref(x, b, dim: int, act: str, alpha: float, gain: float, clamp: Optional[float]):
    """Plain version of the forward: fp32 (or wider) arithmetic, output in
    x's dtype; ``b`` [C] along ``dim``."""
    y = _act(x.to(_compute_dtype(x)) + _bias_view(b, x, dim), act, alpha) * gain
    if clamp is not None:
        y = y.clamp(-clamp, clamp)
    return y.to(x.dtype)


def bias_act_ref_backward(dy, x, b, dim: int, act: str, alpha: float, gain: float,
                          clamp: Optional[float]):
    """Plain version of the backward, the formula the kernel implements:
    dz = dy * gain * act'(x + b), zero where the clamp cut; dx = dz in x's
    dtype; db = dz summed over every position but the channel's."""
    z = x.to(_compute_dtype(x)) + _bias_view(b, x, dim)
    dz = dy.to(z.dtype) * gain * _act_grad(z, act, alpha)
    if clamp is not None:
        dz = torch.where((_act(z, act, alpha) * gain).abs() > clamp, 0.0, dz)
    others = [d for d in range(x.dim()) if d != dim]
    return dz.to(x.dtype), dz.sum(dim=others).to(b.dtype)


@functools.cache
def _lib():
    lib = _build.load("bias_act")
    fwd = lib.layoutdetr_bias_act_forward
    fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                                            ctypes.c_int, ctypes.c_float, ctypes.c_float,
                                            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    bwd = lib.layoutdetr_bias_act_backward
    bwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                                            ctypes.c_int, ctypes.c_float, ctypes.c_float,
                                            ctypes.c_float, ctypes.c_int, ctypes.c_longlong,
                                            ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    chunk = lib.layoutdetr_bias_act_chunk
    chunk.argtypes = []
    chunk.restype = ctypes.c_longlong
    return fwd, bwd, chunk()


def _geometry(x, dim):
    """(outer, C, inner) of x read as [outer, C, inner] around ``dim``."""
    return math.prod(x.shape[:dim]), x.shape[dim], math.prod(x.shape[dim + 1:])


def _check(x, b, dim, *others):
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"bias_act takes float32 or bfloat16 on the card, got {x.dtype}")
    if b.dtype != torch.float32 or b.dim() != 1 or b.shape[0] != x.shape[dim] or not b.is_contiguous():
        raise ValueError(f"b must be a contiguous float32 [{x.shape[dim]}] tensor")
    for t in (x, *others):
        if t.device != x.device or t.dtype != x.dtype or t.shape != x.shape:
            raise ValueError("bias_act's tensors must share x's device, dtype and shape")
        if not t.is_contiguous():
            raise ValueError("bias_act takes contiguous tensors")
    if b.device != x.device:
        raise ValueError(f"b is on {b.device}, x on {x.device}")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def bias_act_forward(x, b, dim: int, act: str, alpha: float, gain: float,
                     clamp: Optional[float]):
    """The forward kernel on a CUDA tensor (b fp32 [C]); the plain version
    on a CPU tensor."""
    if x.device.type == "cpu":
        return bias_act_ref(x, b, dim, act, alpha, gain, clamp)
    if x.device.type != "cuda":
        raise ValueError(f"bias_act runs on CUDA or CPU tensors, got {x.device}")
    _check(x, b, dim)
    outer, c, inner = _geometry(x, dim)
    y = torch.empty_like(x)
    fwd, _, _ = _lib()
    with torch.cuda.device(x.device):
        err = fwd(x.data_ptr(), b.data_ptr(), y.data_ptr(), outer, c, inner,
                  activation_funcs[act].code, alpha, gain, -1.0 if clamp is None else clamp,
                  _DTYPE_CODE[x.dtype], _stream(x))
    if err != 0:
        raise RuntimeError(f"bias_act forward launch failed: cudaError {err}")
    LAUNCHES["forward"] += 1
    return y


def bias_act_backward(dy, x, b, dim: int, act: str, alpha: float, gain: float,
                      clamp: Optional[float]):
    """(dx, db) by the backward kernels on CUDA tensors; the plain version
    on CPU tensors."""
    if x.device.type == "cpu":
        return bias_act_ref_backward(dy, x, b, dim, act, alpha, gain, clamp)
    if x.device.type != "cuda":
        raise ValueError(f"bias_act runs on CUDA or CPU tensors, got {x.device}")
    _check(x, b, dim, dy)
    outer, c, inner = _geometry(x, dim)
    _, bwd, chunk = _lib()
    nchunks = (outer * inner + chunk - 1) // chunk
    dx = torch.empty_like(x)
    partial = torch.empty(c * nchunks, dtype=torch.float32, device=x.device)
    db = torch.empty(c, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = bwd(dy.data_ptr(), x.data_ptr(), b.data_ptr(), dx.data_ptr(), partial.data_ptr(),
                  db.data_ptr(), outer, c, inner, activation_funcs[act].code, alpha, gain,
                  -1.0 if clamp is None else clamp, _DTYPE_CODE[x.dtype], nchunks, _stream(x))
    if err != 0:
        raise RuntimeError(f"bias_act backward launch failed: cudaError {err}")
    LAUNCHES["backward"] += 1
    return dx, db


class _BiasAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, b, dim, act, alpha, gain, clamp):
        ctx.save_for_backward(x, b)
        ctx.args = (dim, act, alpha, gain, clamp)
        return bias_act_forward(x, b, dim, act, alpha, gain, clamp)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, b = ctx.saved_tensors
        dx, db = bias_act_backward(dy.contiguous(), x, b, *ctx.args)
        return dx, db, None, None, None, None, None


def bias_act(x, b=None, dim: int = 1, act: str = "linear", alpha=None, gain=None,
             clamp: Optional[float] = None):
    """Add ``b`` along ``dim``, apply ``act``, scale by ``gain``, clamp to
    ±``clamp`` (reference bias_act.py:53-121). ``alpha``/``gain`` default
    to the activation's. Differentiable in x and b (once)."""
    alpha, gain = _resolve(act, alpha, gain)
    if clamp is not None and clamp < 0:
        raise ValueError("clamp must be >= 0")
    dim = dim % x.dim()
    if b is None:
        b = torch.zeros(x.shape[dim], dtype=torch.float32, device=x.device)
    if x.device.type == "cuda":
        b = b.float().contiguous()
    return _BiasAct.apply(x, b, dim, act, alpha, gain, clamp)
