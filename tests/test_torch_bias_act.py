"""Port bias_act vs the JAX package's, and the CUDA kernels vs their plain
versions (on a card only).

On the CPU the port's autograd Function runs ``bias_act_ref`` and
``bias_act_ref_backward``, the formulas the kernels implement. Held
against JAX ``bias_act(impl="xla")`` (values), ``_bias_act_pallas`` in
interpret mode (values, as tests/test_ops.py:33 runs it) and
``jax.grad`` (dx, db), for all 9 activations with an explicit gain,
alpha and clamp, the channel dim last and at 1. fp32 bars: 1e-5 max-abs
relative to max |y| (or max |g|): both sides do the same fp32 arithmetic,
with exp/tanh from other libraries. The plain backward is also checked by
``torch.autograd.gradcheck`` in float64.
"""

import ctypes
import importlib
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from layoutdetr_tpu_torch.ops import bias_act as port

from test_torch_common import one_torch_thread  # noqa: F401 (module-scoped autouse fixture)

jax_bias_act_mod = importlib.import_module("layoutdetr_tpu.ops.bias_act")  # the package exports the function

ACTS = list(port.activation_funcs)
CASES = [(act, dim) for act in ACTS for dim in (-1, 1)]


def _inputs(dim, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, 6, 5)).astype(np.float32) * 1.5
    c = x.shape[dim]
    b = rng.normal(size=(c,)).astype(np.float32) * 0.5
    dy = rng.normal(size=x.shape).astype(np.float32)
    return x, b, dy


def _kw(act):
    return dict(act=act, alpha=0.3 if act == "lrelu" else None, gain=1.3, clamp=0.9)


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("act,dim", CASES, ids=[f"{a}-dim{d}" for a, d in CASES])
def test_values_and_grads_match_jax(act, dim):
    x, b, dy = _inputs(dim)
    kw = _kw(act)
    jx, jb = jnp.asarray(x), jnp.asarray(b)
    want = np.asarray(jax_bias_act_mod.bias_act(jx, jb, dim=dim, **kw))
    pallas = np.asarray(jax_bias_act_mod.bias_act(jx, jb, dim=dim, impl="pallas_interpret", **kw))

    tx = torch.from_numpy(x).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    got = port.bias_act(tx, tb, dim=dim, **kw)
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert _rel(got, want) <= 1e-5, f"{act} vs JAX xla: {_rel(got, want):.2e}"
    assert _rel(got, pallas) <= 1e-5, f"{act} vs JAX pallas: {_rel(got, pallas):.2e}"

    def f(xx, bb):
        return jnp.sum(jax_bias_act_mod.bias_act(xx, bb, dim=dim, **kw) * dy)

    want_dx, want_db = jax.grad(f, argnums=(0, 1))(jx, jb)
    got_dx, got_db = torch.autograd.grad(got, (tx, tb), torch.from_numpy(dy))
    assert _rel(got_dx, want_dx) <= 1e-5, f"{act} dx: {_rel(got_dx, want_dx):.2e}"
    assert _rel(got_db, want_db) <= 1e-5, f"{act} db: {_rel(got_db, want_db):.2e}"


@pytest.mark.parametrize("act", ACTS)
def test_plain_backward_gradcheck(act):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 3, 4)) * 1.5).requires_grad_(True)
    b = torch.from_numpy(rng.normal(size=(3,)) * 0.5).requires_grad_(True)
    clamp = 0.9 if act != "linear" else None
    assert torch.autograd.gradcheck(
        lambda xx, bb: port.bias_act(xx, bb, dim=1, act=act, gain=1.3, clamp=clamp), (x, b))


def test_defaults_no_bias_and_launch_count():
    x = torch.from_numpy(_inputs(1)[0])
    before = dict(port.LAUNCHES)
    got = port.bias_act(x, act="lrelu")  # default alpha 0.2, gain sqrt(2), dim 1
    want = torch.where(x >= 0, x, 0.2 * x) * np.sqrt(2)
    assert torch.allclose(got, want, atol=1e-6)
    # CPU tensors take the plain version: no kernel is launched
    assert port.LAUNCHES == before


def _non_finite_inputs(dim, device="cpu"):
    x, b, dy = (torch.from_numpy(a).to(device) for a in _inputs(dim))
    x[0, 0, :3] = torch.tensor([float("nan"), float("inf"), -float("inf")])
    return x, b, dy


@pytest.mark.parametrize("act", ["linear", "lrelu"])
def test_clamp_keeps_nan_as_jax_does(act):
    """A clamp keeps NaN (jnp.clip and torch.clamp do); +-inf clamp to +-clamp."""
    x, b, _ = _non_finite_inputs(1)
    kw = _kw(act)
    got = port.bias_act(x, b, dim=1, **kw).numpy()
    want = np.asarray(jax_bias_act_mod.bias_act(jnp.asarray(x.numpy()), jnp.asarray(b.numpy()),
                                                dim=1, **kw))
    assert np.isnan(got[0, 0, 0]) and np.isfinite(got.reshape(-1)[1:]).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.nanmax(np.abs(want)))


def test_bf16_computes_in_fp32():
    x, b, _ = _inputs(1)
    got = port.bias_act(torch.from_numpy(x).bfloat16(), torch.from_numpy(b), act="swish", gain=1.3)
    want = port.bias_act(torch.from_numpy(x).bfloat16().float(), torch.from_numpy(b), act="swish",
                         gain=1.3)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.bfloat16())


def test_double_backward_raises():
    x = torch.from_numpy(_inputs(1)[0]).requires_grad_(True)
    y = port.bias_act(x, act="lrelu")
    (g,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    with pytest.raises(RuntimeError):
        g.sum().backward()


@pytest.mark.parametrize("case", ["dtype", "bias_shape", "bias_dtype", "strided", "bias_strided",
                                  "dy_shape", "dy_dtype"])
def test_wrapper_checks_raise(case):
    """The per-call checks and the plan raise on what the kernels do not
    take: there is no fallback."""
    x = torch.zeros(2, 4, 8)
    b = torch.zeros(4)
    dy = torch.zeros(2, 4, 8)
    if case == "dtype":
        x = x.half()
    elif case == "bias_shape":
        b = torch.zeros(5)
    elif case == "bias_dtype":
        b = b.double()
    elif case == "strided":
        x = torch.zeros(2, 8, 4).transpose(1, 2)
    elif case == "bias_strided":
        b = torch.zeros(8)[::2]
    elif case == "dy_shape":
        dy = torch.zeros(2, 4, 4)
    else:
        dy = dy.bfloat16()
    with pytest.raises((TypeError, ValueError)):
        port._check(x, b, 1, "linear", 0.0, 1.0, None, dy)


# (shape, dtype, variant, threads and grid forward, threads and grid backward, cluster)
PLANS = [
    ((16, 512), torch.float32, "fc_vec", 128, (1, 16), 256, (4, 1), 1),
    ((16, 510), torch.float32, "fc_scalar", 128, (4, 16), 256, (16, 1), 1),
    ((16, 512), torch.bfloat16, "fc_vec", 64, (1, 16), 256, (2, 1), 1),
    ((40, 8), torch.float32, "fc_vec", 32, (1, 40), 256, (1, 1), 1),
    ((16, 32, 256, 256), torch.float32, "map_vec", 256, (33, 32), 512, (16, 32), 16),
    ((16, 3, 256, 256), torch.bfloat16, "map_vec", 256, (128, 3), 1024, (16, 3), 16),
    ((16, 64, 32, 32), torch.float32, "map_vec", 256, (4, 64), 256, (4, 64), 4),
    ((16, 64, 128, 128), torch.float32, "map_vec", 256, (17, 64), 256, (16, 64), 16),
    ((16, 66, 1280), torch.float32, "map_vec", 256, (5, 66), 256, (5, 66), 5),
    ((16, 512, 4, 4), torch.bfloat16, "map_vec", 32, (1, 512), 32, (1, 512), 1),
    ((4, 7, 33), torch.float32, "map_scalar", 160, (1, 7), 160, (1, 7), 1),
]


@pytest.mark.parametrize("shape,dtype,variant,threads,fwd,bwd_threads,bwd,cluster", PLANS,
                         ids=[f"{list(p[0])}-{str(p[1])[6:]}" for p in PLANS])
def test_plan_per_shape(shape, dtype, variant, threads, fwd, bwd_threads, bwd, cluster):
    """Form, vector width, grid and cluster size chosen per shape: FC for
    [B, C] (a row per forward block, 8 row slots a backward block), 16-byte
    vectors where C (FC) or inner (map) allows them, about 8 blocks an SM
    forward, at most 16 blocks a channel in the backward's cluster (wider
    blocks where the channels are few), the scalar form for an odd inner or
    C."""
    plan = port.make_plan(shape, dtype, (shape[1],), torch.float32, 1, "lrelu", 0.2, 1.4, None)
    launch = plan.pick(0)  # an aligned pointer
    assert (launch.variant, launch.threads, launch.fwd_grid, launch.bwd_threads, launch.bwd_grid,
            launch.cluster) == (variant, threads, fwd, bwd_threads, bwd, cluster)
    assert launch.vec == (1 if variant.endswith("scalar") else {torch.float32: 4,
                                                                 torch.bfloat16: 8}[dtype])
    assert plan.scalar.vec == 1 and plan.scalar.variant == variant.split("_")[0] + "_scalar"
    assert 1 <= cluster <= 16 and launch.threads % 32 == 0 and launch.bwd_threads % 32 == 0
    params = launch.params
    assert (params.threads, params.bwd_threads, params.fwd_grid_x, params.fwd_grid_y,
            params.bwd_grid_x) == (threads, bwd_threads, fwd[0], fwd[1] if variant[:2] == "fc"
                                   else 0, bwd[0])
    assert params.channels == shape[1] and params.need_x == 1 and params.clamp == -1.0


def test_plan_cache_key_covers_the_signature():
    """One plan per (shape, dtype, b's dtype, dim, act, alpha, gain, clamp):
    the same call finds the same plan, a change of any of them another."""
    x, b = torch.zeros(2, 4, 8), torch.zeros(4)
    base = ("lrelu", 0.2, 1.4, None)
    plan = port._check(x, b, 1, *base)
    assert port._check(x, b, 1, *base) is plan
    others = [port._check(x.bfloat16(), b, 1, *base), port._check(x, b.bfloat16(), 1, *base),
              port._check(x, b, 1, "linear", 0.2, 1.4, None),
              port._check(x, b, 1, "lrelu", 0.3, 1.4, None),
              port._check(x, b, 1, "lrelu", 0.2, 1.0, None),
              port._check(x, b, 1, "lrelu", 0.2, 1.4, 0.5),
              port._check(torch.zeros(2, 4, 16), b, 1, *base)]
    assert all(p is not plan for p in others)
    assert len({id(p) for p in others}) == len(others)
    assert others[1].scalar.params.b_bf16 == 1 and others[0].scalar.params.dtype == 1
    assert others[5].scalar.params.clamp == pytest.approx(0.5)


def test_misaligned_or_odd_inner_takes_the_scalar_form():
    """A tensor that does not start on 16 bytes (storage_offset 1) or whose
    rows cannot all start on 16 bytes (inner 33) takes the scalar form."""
    b = torch.zeros(4)
    x = torch.zeros(2 * 4 * 8 + 1)[1:].view(2, 4, 8)
    plan = port._check(x, b, 1, "lrelu", 0.2, 1.4, None)
    assert plan.vector is not None and plan.vector.variant == "map_vec"
    assert plan.pick(x.data_ptr()) is plan.scalar
    assert plan.pick(torch.zeros(2, 4, 8).data_ptr()) is plan.vector
    assert plan.pick(16 | 8) is plan.scalar  # any operand off 16 bytes
    odd = port._check(torch.zeros(2, 4, 33), b, 1, "lrelu", 0.2, 1.4, None)
    assert odd.vector is None and odd.pick(0).variant == "map_scalar"
    fc = port._check(torch.zeros(3, 6), torch.zeros(6), 1, "linear", 0.0, 1.0, None)
    assert fc.vector is None and fc.pick(0).variant == "fc_scalar"


def test_params_struct_and_pass_through():
    """The ctypes Structure carries the plan's scalars; a linear call with
    gain 1 and no clamp passes dy through and reads no x."""
    assert ctypes.sizeof(port._Params) == 88  # sizeof(Params) in bias_act.cu on x86-64
    lin = port.make_plan((16, 512), torch.float32, (512,), torch.bfloat16, 1, "linear", 0.0, 1.0,
                         None)
    assert lin.pass_through and lin.vector.params.need_x == 0 and lin.vector.params.b_bf16 == 1
    scaled = port.make_plan((16, 512), torch.float32, (512,), torch.float32, 1, "linear", 0.0,
                            2.0, None)
    assert not scaled.pass_through and scaled.vector.params.need_x == 0
    clamped = port.make_plan((16, 512), torch.float32, (512,), torch.float32, 1, "linear", 0.0,
                             1.0, 4.0)
    assert not clamped.pass_through and clamped.vector.params.need_x == 1
    assert lin.vector.addr == ctypes.addressof(lin.vector.params)


def test_plain_linear_backward_passes_dy_through():
    x, b, dy = (torch.from_numpy(a) for a in _inputs(1))
    dx, db = port.bias_act_ref_backward(dy, x, b, 1, "linear", 0.0, 1.0, None)
    assert torch.equal(dx, dy)
    assert torch.allclose(db, dy.sum(dim=(0, 2)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("act", ["lrelu", "linear"])
def test_bf16_bias_gives_the_rounded_fp32_bias(act):
    """A bf16 b gives what the fp32 b rounded to bf16 gives, forward and
    backward (db then in b's dtype)."""
    x, b, dy = _inputs(1)
    xt = torch.from_numpy(x).bfloat16()
    b16 = torch.from_numpy(b).bfloat16().requires_grad_(True)
    b32 = b16.detach().float().requires_grad_(True)
    x16, x32 = xt.clone().requires_grad_(True), xt.clone().requires_grad_(True)
    kw = dict(act=act, gain=1.3 if act == "lrelu" else None, clamp=0.9 if act == "lrelu" else None)
    y16, y32 = port.bias_act(x16, b16, **kw), port.bias_act(x32, b32, **kw)
    assert torch.equal(y16, y32)
    g = torch.from_numpy(dy).bfloat16()
    y16.backward(g)
    y32.backward(g)
    assert torch.equal(x16.grad, x32.grad)
    assert b16.grad.dtype == torch.bfloat16 and torch.equal(b16.grad, b32.grad.bfloat16())


def _bias_of_kind(b, kind):
    """b (fp32, 1-D) as an fp16, fp64 or strided tensor."""
    if kind == "strided":
        return torch.stack([b, torch.zeros_like(b)], dim=1)[:, 0]
    return b.to({"float16": torch.float16, "float64": torch.float64}[kind])


def _any_bias_matches_fp32(device):
    """``bias_act`` with an fp16, fp64 or strided b gives what that b's
    values in a contiguous fp32 tensor give, and b's gradient comes back
    in b's dtype."""
    x, b, dy = (torch.from_numpy(a).to(device) for a in _inputs(1))
    kw = dict(act="lrelu", gain=1.3, clamp=0.9)
    for kind in ("float16", "float64", "strided"):
        bk = _bias_of_kind(b, kind).requires_grad_(True)
        b32 = bk.detach().float().contiguous().requires_grad_(True)
        y = port.bias_act(x, bk, **kw)
        want = port.bias_act(x, b32, **kw)
        assert torch.equal(y, want), kind
        y.backward(dy)
        want.backward(dy)
        assert bk.grad.dtype == bk.dtype and torch.equal(bk.grad, b32.grad.to(bk.dtype)), kind


def test_bias_act_takes_any_float_bias():
    _any_bias_matches_fp32("cpu")


@pytest.mark.cuda
def test_bias_act_takes_any_float_bias_on_card():
    """On the card ``bias_act`` makes such a b contiguous fp32 before the
    kernels, which take only a contiguous fp32 or bf16 b."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _any_bias_matches_fp32("cuda")


def _any_x_layout_matches_contiguous(device):
    """``bias_act`` on a non-contiguous x (channels last, as a convolution
    of a permuted NHWC image returns it; a transposed [C, N] matrix) gives
    what the same values in a contiguous x give, and the same gradients:
    the same bits on the card, which copies x to a contiguous tensor; on
    the CPU db sums the positions in the layout's order, to 1e-6 of
    max |db|."""
    g = torch.Generator(device=device).manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        for x0 in (torch.randn(2, 8, 5, 6, device=device, generator=g)
                   .to(memory_format=torch.channels_last),
                   torch.randn(8, 3, device=device, generator=g).t()):
            x0 = x0.to(dtype)
            assert not x0.is_contiguous()
            b0 = torch.randn(x0.shape[1], device=device, generator=g)
            dy = torch.randn(x0.shape, device=device, generator=g).to(dtype)
            got, want = [], []
            for x_in, out in ((x0, got), (x0.contiguous(), want)):
                x = x_in.detach().clone(memory_format=torch.preserve_format).requires_grad_(True)
                b = b0.clone().requires_grad_(True)
                y = port.bias_act(x, b, act="lrelu", gain=1.3, clamp=0.9)
                y.backward(dy)
                out += [y, x.grad, b.grad]
            for a, w in zip(got[:2], want[:2]):
                assert torch.equal(a.contiguous(), w), dtype
            db_err = float((got[2] - want[2]).abs().max())
            assert db_err <= (0.0 if device == "cuda" else 1e-6 * float(want[2].abs().max()))


def test_bias_act_takes_any_x_layout():
    _any_x_layout_matches_contiguous("cpu")


@pytest.mark.cuda
def test_bias_act_takes_any_x_layout_on_card():
    """On the card ``bias_act`` copies a non-contiguous x to a contiguous
    one before the kernels (LayoutGAN++'s encoder gives its first layer a
    channels-last conv output)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _any_x_layout_matches_contiguous("cuda")


def _card_case(shape, dtype, seed=0, dim=1):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, device="cuda", generator=g).to(dtype)
    b = torch.randn(shape[dim], device="cuda", generator=g)
    dy = torch.randn(shape, device="cuda", generator=g).to(dtype)
    return x, b, dy


def _assert_matches_plain(x, b, dy, dim, kw, y, dx, db):
    want_y = port.bias_act_ref(x.float(), b, dim, **kw)
    want_dx, want_db = port.bias_act_ref_backward(dy.float(), x.float(), b, dim, **kw)
    ytol, dtol = (1e-6, 1e-5) if x.dtype == torch.float32 else (2 ** -8, 2 ** -8)
    assert float((y.float() - want_y).abs().max()) <= ytol * float(want_y.abs().max())
    assert float((dx.float() - want_dx).abs().max()) <= ytol * float(want_dx.abs().max())
    assert float((db - want_db.float()).abs().max()) <= dtol * float(want_db.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,dim", [((16, 32, 64, 64), 1), ((16, 512), 1), ((16, 3, 8, 8), 1),
                                       ((4, 7, 33), 2), ((16, 510), 1), ((5, 6), 1),
                                       ((3, 5, 7, 9), 1)])
@pytest.mark.parametrize("act", ["lrelu", "linear", "swish", "elu"])
def test_kernels_match_plain_on_card(dtype, shape, dim, act):
    """Forward and backward kernels vs the plain versions on the same
    inputs: fp32 1e-6 of max |y| (forward) and 1e-5 of max |db| (another
    sum order); bf16 within one bf16 rounding (2^-8) of the fp32 plain
    version of the same bf16 inputs. db is the same in two runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, b, dy = _card_case(shape, dtype, dim=dim)
    kw = dict(act=act, alpha=0.2, gain=1.4, clamp=2.5 if act == "lrelu" else None)
    n_fwd, n_bwd = port.LAUNCHES["forward"], port.LAUNCHES["backward"]
    y = port.bias_act_forward(x, b, dim, **kw)
    dx, db = port.bias_act_backward(dy, x, b, dim, **kw)
    _, db2 = port.bias_act_backward(dy, x, b, dim, **kw)
    torch.cuda.synchronize()
    assert port.LAUNCHES["forward"] == n_fwd + 1
    assert port.LAUNCHES["backward"] == n_bwd + 2
    assert y.dtype == dtype and dx.dtype == dtype and db.dtype == torch.float32
    _assert_matches_plain(x, b, dy, dim, kw, y, dx, db)
    assert torch.equal(db, db2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["linear", "lrelu"])
def test_kernels_keep_nan_under_clamp_on_card(dtype, act):
    """NaN and +-inf inputs with a clamp: the kernels give the plain
    versions' values, NaN where they have NaN (the clamp keeps it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, b, dy = _non_finite_inputs(1, "cuda")
    x, dy = x.to(dtype), dy.to(dtype)
    kw = _kw(act)
    alpha, gain = port._resolve(act, kw.pop("alpha"), kw.pop("gain"))
    args = (1, act, alpha, gain, kw["clamp"])
    y = port.bias_act_forward(x, b, *args)
    dx, db = port.bias_act_backward(dy, x, b, *args)
    want_y = port.bias_act_ref(x.float(), b, *args)
    want_dx, want_db = port.bias_act_ref_backward(dy.float(), x.float(), b, *args)
    tol = 1e-6 if dtype == torch.float32 else 2 ** -8
    for got, want in ((y, want_y), (dx, want_dx), (db, want_db)):
        got, want = got.float().cpu(), want.float().cpu()
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.allclose(got, want, rtol=0, atol=tol * float(want.nan_to_num().abs().max()),
                              equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("ranks", range(1, 17))
def test_cluster_ranks_match_plain_on_card(ranks):
    """The map backward with 1 to 16 blocks in a channel's cluster: dx and
    db vs the plain version, db bit-equal in two runs, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, b, dy = _card_case((16, 66, 256 * ranks), torch.float32, seed=ranks)
    kw = dict(act="lrelu", alpha=0.2, gain=1.4, clamp=2.5)
    plan = port._check(x, b, 1, *kw.values(), dy)
    assert plan.pick(x.data_ptr() | dy.data_ptr()).cluster == ranks
    n_fwd, n_bwd = port.LAUNCHES["forward"], port.LAUNCHES["backward"]
    y = port.bias_act_forward(x, b, 1, **kw)
    dx, db = port.bias_act_backward(dy, x, b, 1, **kw)
    _, db2 = port.bias_act_backward(dy, x, b, 1, **kw)
    torch.cuda.synchronize()
    assert (port.LAUNCHES["forward"], port.LAUNCHES["backward"]) == (n_fwd + 1, n_bwd + 2)
    _assert_matches_plain(x, b, dy, 1, kw, y, dx, db)
    assert torch.equal(db, db2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(16, 32, 64, 64), (16, 512)])
def test_storage_offset_takes_the_scalar_form_on_card(dtype, shape):
    """x and dy one element past a 16-byte boundary: the scalar form, the
    plain version's values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n = math.prod(shape)
    x0, b, dy0 = _card_case((n + 1,), dtype, dim=0)
    b = b[:shape[1]].contiguous()
    x, dy = x0[1:].view(shape), dy0[1:].view(shape)
    assert x.storage_offset() == 1
    kw = dict(act="lrelu", alpha=0.2, gain=1.4, clamp=None)
    plan = port._check(x, b, 1, *kw.values(), dy)
    assert plan.vector is not None and plan.pick(x.data_ptr() | dy.data_ptr()) is plan.scalar
    y = port.bias_act_forward(x, b, 1, **kw)
    dx, db = port.bias_act_backward(dy, x, b, 1, **kw)
    torch.cuda.synchronize()
    _assert_matches_plain(x, b, dy, 1, kw, y, dx, db)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(16, 512), (16, 3, 64, 64)])
def test_linear_pass_through_on_card(dtype, shape):
    """Linear, gain 1, no clamp: dx is dy itself (no copy), db is the sum
    of dy, in one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, b, dy = _card_case(shape, dtype)
    n_bwd = port.LAUNCHES["backward"]
    dx, db = port.bias_act_backward(dy, x, b, 1, "linear", 0.0, 1.0, None)
    torch.cuda.synchronize()
    assert port.LAUNCHES["backward"] == n_bwd + 1
    assert dx is dy and dx.data_ptr() == dy.data_ptr()
    want = dy.float().sum(dim=[d for d in range(dy.dim()) if d != 1])
    assert float((db - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["linear", "lrelu"])
def test_bf16_bias_on_card(act):
    """The kernel reads a bf16 b itself: the same y and dx, bit for bit, as
    that b widened to fp32, and through autograd db comes back in bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, b, dy = _card_case((16, 32, 32, 32), torch.bfloat16)
    b16 = b.bfloat16()
    args = (1, act, 0.2, 1.4 if act == "lrelu" else 1.0, None)
    assert torch.equal(port.bias_act_forward(x, b16, *args), port.bias_act_forward(x, b16.float(), *args))
    dx16, db16 = port.bias_act_backward(dy, x, b16, *args)
    dx32, db32 = port.bias_act_backward(dy, x, b16.float(), *args)
    assert torch.equal(dx16, dx32) and torch.equal(db16, db32) and db16.dtype == torch.float32
    xr, br = x.clone().requires_grad_(True), b16.clone().requires_grad_(True)
    port.bias_act(xr, br, act=act).backward(dy)
    assert br.grad.dtype == torch.bfloat16 and xr.grad.dtype == torch.bfloat16
