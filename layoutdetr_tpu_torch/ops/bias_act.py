"""Fused bias + activation + gain + clamp: a hand-written CUDA kernel for
Hopper, forward and backward, and its plain PyTorch version.

Counterpart of ``layoutdetr_tpu/ops/bias_act.py``. The TPU kernel
(``_bias_act_pallas``, body ``_bias_act_kernel``) becomes
``csrc/bias_act.cu``; its source note says how it is laid out and what
bounds it on an H100. ``y = clamp(act(x + b[c]) * gain, ±clamp)`` is
computed in fp32 and stored in x's dtype, for the 9 activations of
``activation_funcs`` with their default alpha and gain (reference
bias_act.py:22-32). b may be fp32 or bf16; the kernel widens it.

``bias_act`` is a ``torch.autograd.Function``: its forward launches
``bias_act_forward`` and its backward ``bias_act_backward`` (dx and a
deterministic per-channel db in one launch, recomputing ``x + b`` from x
and b) for CUDA tensors, and the plain versions ``bias_act_ref`` /
``bias_act_ref_backward`` for CPU tensors; there is no fallback from one
to the other. Double backward (the R1 penalty) is out of scope and
raises. ``LAUNCHES["forward"]`` and ``LAUNCHES["backward"]`` count the
wrappers' kernel launches, one per call.

The host path is kept to about one PyTorch op a call: a ``Plan`` per call
signature (shapes, dtypes, dim, act, alpha, gain, clamp) is built once and
cached. It holds the kernel's form and grid (``Launch``) for 16-byte
loads and for scalar loads, and their scalars in a ctypes Structure that
the C entry points take by pointer. Per call only the device, contiguity
and 16-byte alignment (``data_ptr() % 16``) are checked, the output is
allocated, and the stream is read with
``torch._C._cuda_getCurrentRawStream`` (what Triton's launcher uses; it
returns the raw handle without building a Python stream object, which
``torch.cuda.current_stream(dev).cuda_stream`` does: chip_smoke.py times
both). A linear call with gain 1 and no clamp returns dy itself as dx and
launches only the db reduction.
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
_VEC = {torch.float32: 4, torch.bfloat16: 8}  # elements in 16 bytes
LAUNCHES = {"forward": 0, "backward": 0}  # kernel launches, counted where they happen
_SELU_SCALE = 1.0507009873554804934193349852946
_SELU_ALPHA = 1.6732632423543772848170429916717

# Plan geometry for an H100 SXM (132 SMs); on a card with another SM count
# the plans stay correct and only fill it less evenly. A map-form forward
# block has up to 256 threads, and the forward aims at 8 such blocks an SM (2048
# threads), each thread taking at least 4 vectors. The backward's blocks of
# one channel form a cluster of at most 16; where the channels are too few
# to fill the card that way (ToRGB's 3), its blocks grow to up to 1024
# threads to keep enough loads in flight. An FC forward block has up to 128
# threads and takes rows with a stride; the FC backward block is 32 channel
# lanes x 8 row slots (kFcLanes, kFcSlots in bias_act.cu).
_SMS = 132
_TARGET_BLOCKS = 8 * _SMS
_MAP_THREADS = 256
_MAX_THREADS = 1024
_MIN_VECS_PER_THREAD = 4
_MAX_CLUSTER = 16
_FC_THREADS = 128
_FC_LANES = 32
_MAX_GRID_Y = 65535


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


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

class _Params(ctypes.Structure):
    """struct Params of bias_act.cu, field for field."""
    _fields_ = [("form", ctypes.c_int), ("vec", ctypes.c_int), ("dtype", ctypes.c_int),
                ("b_bf16", ctypes.c_int), ("act", ctypes.c_int), ("alpha", ctypes.c_float),
                ("gain", ctypes.c_float), ("clamp", ctypes.c_float), ("need_x", ctypes.c_int),
                ("channels", ctypes.c_int), ("outer", ctypes.c_longlong),
                ("inner", ctypes.c_longlong), ("vecs_per_channel", ctypes.c_uint),
                ("inner_vecs", ctypes.c_uint), ("inner_shift", ctypes.c_int),
                ("fwd_grid_x", ctypes.c_uint), ("fwd_grid_y", ctypes.c_uint),
                ("bwd_grid_x", ctypes.c_uint), ("threads", ctypes.c_int),
                ("bwd_threads", ctypes.c_int)]


@dataclasses.dataclass(frozen=True)
class Launch:
    """One variant of a plan: form and vector width, the forward's threads
    a block and grid, the backward's, and the backward's cluster size
    (blocks per channel; 1 = no cluster). ``addr`` is the address of its
    ``_Params``, which ``params`` keeps alive."""
    variant: str  # "fc_vec", "fc_scalar", "map_vec" or "map_scalar"
    vec: int
    threads: int
    fwd_grid: tuple
    bwd_threads: int
    bwd_grid: tuple
    cluster: int
    params: _Params = dataclasses.field(compare=False, repr=False)
    addr: int = dataclasses.field(compare=False, repr=False)


@dataclasses.dataclass(frozen=True)
class Plan:
    """Everything about a call that its signature fixes."""
    vector: Optional[Launch]  # 16-byte loads, where the shape allows them
    scalar: Launch
    channels: int
    pass_through: bool  # linear, gain 1, no clamp: dx is dy

    def pick(self, ptrs: int) -> Launch:
        """The vector launch if every pointer (OR-ed into ``ptrs``) is
        16-byte aligned and the shape allows it, else the scalar one."""
        return self.vector if self.vector is not None and ptrs % 16 == 0 else self.scalar


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _make_launch(outer: int, c: int, inner: int, vec: int, fields: dict) -> Launch:
    if inner == 1:
        lanes = c // vec
        threads = min(_FC_THREADS, _cdiv(lanes, 32) * 32)
        fwd = (_cdiv(lanes, threads), min(outer, _MAX_GRID_Y))
        bwd, bwd_threads, cluster = (_cdiv(lanes, _FC_LANES), 1), 256, 1
        variant, extra = "fc", dict(form=0, fwd_grid_y=fwd[1])
    else:
        vpc, inner_vecs = outer * inner // vec, inner // vec
        threads = min(_MAP_THREADS, _cdiv(vpc, 32) * 32)
        k = max(1, min(_cdiv(_TARGET_BLOCKS, c), _cdiv(vpc, threads * _MIN_VECS_PER_THREAD)))
        cluster = min(k, _MAX_CLUSTER)
        bwd_threads = threads
        while (bwd_threads < _MAX_THREADS and c * cluster * bwd_threads < _SMS * _MAX_THREADS
               and vpc >= 2 * cluster * bwd_threads * _MIN_VECS_PER_THREAD):
            bwd_threads *= 2
        fwd, bwd = (k, c), (cluster, c)
        shift = inner_vecs.bit_length() - 1 if inner_vecs & (inner_vecs - 1) == 0 else -1
        variant, extra = "map", dict(form=1, vecs_per_channel=vpc, inner_vecs=inner_vecs,
                                     inner_shift=shift)
    params = _Params(vec=vec, threads=threads, bwd_threads=bwd_threads, fwd_grid_x=fwd[0],
                     bwd_grid_x=bwd[0], **fields, **extra)
    return Launch(f"{variant}_{'vec' if vec > 1 else 'scalar'}", vec, threads, fwd, bwd_threads,
                  bwd, cluster, params, ctypes.addressof(params))


def make_plan(shape: tuple, dtype: torch.dtype, b_shape: tuple, b_dtype: torch.dtype, dim: int,
              act: str, alpha: float, gain: float, clamp: Optional[float]) -> Plan:
    """The plan of one call signature; raises on what the kernels do not take."""
    if dtype not in _VEC:
        raise TypeError(f"bias_act takes float32 or bfloat16 on the card, got {dtype}")
    if act not in activation_funcs:
        raise ValueError(f"unknown activation {act!r}")
    outer, c, inner = math.prod(shape[:dim]), shape[dim], math.prod(shape[dim + 1:])
    if b_dtype not in _VEC or tuple(b_shape) != (c,):
        raise ValueError(f"b must be a float32 or bfloat16 [{c}] tensor, got {b_dtype} "
                         f"{list(b_shape)}")
    if outer * c * inner == 0:
        raise ValueError("bias_act's kernels take no empty tensor")
    if inner > 1 and (c > _MAX_GRID_Y or outer * inner >= 2 ** 31):
        raise ValueError(f"bias_act takes at most {_MAX_GRID_Y} channels and 2^31 positions a "
                         f"channel, got {c} and {outer * inner}")
    pass_through = act == "linear" and gain == 1.0 and clamp is None
    fields = dict(dtype=_DTYPE_CODE[dtype], b_bf16=int(b_dtype == torch.bfloat16),
                  act=activation_funcs[act].code, alpha=alpha, gain=gain,
                  clamp=-1.0 if clamp is None else clamp,
                  need_x=int(act != "linear" or clamp is not None), channels=c, outer=outer,
                  inner=inner)
    vec = _VEC[dtype]
    vector = (_make_launch(outer, c, inner, vec, fields)
              if (c if inner == 1 else inner) % vec == 0 else None)
    return Plan(vector, _make_launch(outer, c, inner, 1, fields), c, pass_through)


_plans: dict = {}


def _check(x, b, dim, act, alpha, gain, clamp, *others) -> Plan:
    """The cached plan of this call, after the checks a call needs: b and
    ``others`` (dy) on x's device, contiguous, ``others`` shaped and typed
    as x. Raises on whatever the kernels do not take."""
    key = (x.shape, x.dtype, b.shape, b.dtype, dim, act, alpha, gain, clamp)
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = make_plan(tuple(x.shape), x.dtype, tuple(b.shape), b.dtype, dim,
                                       act, alpha, gain, clamp)
    dev = x.get_device()
    if b.get_device() != dev or not (x.is_contiguous() and b.is_contiguous()):
        raise ValueError("bias_act takes contiguous x and b on one device")
    for t in others:
        if (t.get_device() != dev or t.dtype != x.dtype or t.shape != x.shape
                or not t.is_contiguous()):
            raise ValueError("bias_act's tensors must share x's device, dtype and shape, "
                             "contiguous")
    return plan


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

@functools.cache
def _lib():
    lib = _build.load("bias_act")
    size = lib.layoutdetr_bias_act_params_size()
    if size != ctypes.sizeof(_Params):
        raise RuntimeError(f"bias_act.cu's Params is {size} bytes, _Params {ctypes.sizeof(_Params)}")
    fwd = lib.layoutdetr_bias_act_forward
    fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    bwd = lib.layoutdetr_bias_act_backward
    bwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    return fwd, bwd, torch._C._cuda_getCurrentRawStream


def _on_cpu(x) -> bool:
    if x.is_cuda:
        return False
    if x.device.type != "cpu":
        raise ValueError(f"bias_act runs on CUDA or CPU tensors, got {x.device}")
    return True


def bias_act_forward(x, b, dim: int, act: str, alpha: float, gain: float,
                     clamp: Optional[float]):
    """The forward kernel on a CUDA tensor (b fp32 or bf16 [C]); the plain
    version on a CPU tensor."""
    if _on_cpu(x):
        return bias_act_ref(x, b, dim, act, alpha, gain, clamp)
    plan = _check(x, b, dim, act, alpha, gain, clamp)
    xp = x.data_ptr()
    launch = plan.pick(xp)
    y = torch.empty_like(x)
    fwd, _, stream = _lib()
    dev = x.get_device()
    err = fwd(launch.addr, xp, b.data_ptr(), y.data_ptr(), dev, stream(dev))
    if err != 0:
        raise RuntimeError(f"bias_act forward ({launch.variant}) launch failed: cudaError {err}")
    LAUNCHES["forward"] += 1
    return y


def bias_act_backward(dy, x, b, dim: int, act: str, alpha: float, gain: float,
                      clamp: Optional[float]):
    """(dx, db) by one backward launch on CUDA tensors, db in fp32; dx is
    dy itself for a linear call with gain 1 and no clamp. The plain version
    on CPU tensors."""
    if _on_cpu(x):
        return bias_act_ref_backward(dy, x, b, dim, act, alpha, gain, clamp)
    plan = _check(x, b, dim, act, alpha, gain, clamp, dy)
    xp, dyp = x.data_ptr(), dy.data_ptr()
    launch = plan.pick(xp | dyp)
    if plan.pass_through:
        dx, dxp = dy, None
    else:
        dx = torch.empty_like(x)
        dxp = dx.data_ptr()
    db = dy.new_empty(plan.channels, dtype=torch.float32)
    _, bwd, stream = _lib()
    dev = x.get_device()
    err = bwd(launch.addr, dyp, xp, b.data_ptr(), dxp, db.data_ptr(), dev, stream(dev))
    if err != 0:
        raise RuntimeError(f"bias_act backward ({launch.variant}) launch failed: cudaError {err}")
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
    to the activation's. Differentiable in x and b (once); b's gradient
    comes back in b's dtype. b may have any floating dtype and layout: on
    the card the kernels read a contiguous fp32 or bf16 b as it is, and
    any other b is first made one (fp16 and fp64 widened or rounded to
    fp32), which costs a launch. x may have any layout too: on the card a
    non-contiguous x (a convolution's channels-last output, say) is first
    copied to a contiguous one. ``bias_act_forward`` and
    ``bias_act_backward`` take only contiguous tensors."""
    alpha, gain = _resolve(act, alpha, gain)
    if clamp is not None and clamp < 0:
        raise ValueError("clamp must be >= 0")
    dim = dim % x.dim()
    if x.is_cuda and not x.is_contiguous():
        x = x.contiguous()
    if b is None:
        b = x.new_zeros(x.shape[dim], dtype=torch.float32)
    elif x.is_cuda and (b.dtype not in _VEC or not b.is_contiguous()):
        b = (b if b.dtype in _VEC else b.float()).contiguous()
    return _BiasAct.apply(x, b, dim, act, alpha, gain, clamp)
