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

import importlib

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


@pytest.mark.parametrize("case", ["dtype", "bias_shape", "bias_dtype", "strided"])
def test_wrapper_checks_raise(case):
    x = torch.zeros(2, 4, 8)
    b = torch.zeros(4)
    if case == "dtype":
        x = x.half()
    elif case == "bias_shape":
        b = torch.zeros(5)
    elif case == "bias_dtype":
        b = b.double()
    else:
        x = torch.zeros(2, 8, 4).transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        port._check(x, b, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,dim", [((16, 32, 64, 64), 1), ((16, 512), 1), ((16, 3, 8, 8), 1),
                                       ((4, 7, 33), 2)])
@pytest.mark.parametrize("act", ["lrelu", "linear", "swish", "elu"])
def test_kernels_match_plain_on_card(dtype, shape, dim, act):
    """Forward and backward kernels vs the plain versions on the same
    inputs: fp32 1e-6 of max |y| (forward) and 1e-5 of max |db| (another
    sum order); bf16 within one bf16 rounding (2^-8) of the fp32 plain
    version of the same bf16 inputs. db is the same in two runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(shape, device="cuda", generator=g).to(dtype)
    b = torch.randn(shape[dim], device="cuda", generator=g)
    dy = torch.randn(shape, device="cuda", generator=g).to(dtype)
    kw = dict(act=act, alpha=0.2, gain=1.4, clamp=2.5 if act == "lrelu" else None)
    n_fwd, n_bwd = port.LAUNCHES["forward"], port.LAUNCHES["backward"]
    y = port.bias_act_forward(x, b, dim, **kw)
    dx, db = port.bias_act_backward(dy, x, b, dim, **kw)
    _, db2 = port.bias_act_backward(dy, x, b, dim, **kw)
    torch.cuda.synchronize()
    assert port.LAUNCHES["forward"] == n_fwd + 1
    assert port.LAUNCHES["backward"] == n_bwd + 2
    want_y = port.bias_act_ref(x.float(), b, dim, **kw)
    want_dx, want_db = port.bias_act_ref_backward(dy.float(), x.float(), b, dim, **kw)
    ytol, dtol = (1e-6, 1e-5) if dtype == torch.float32 else (2 ** -8, 2 ** -8)
    assert y.dtype == dtype and dx.dtype == dtype and db.dtype == torch.float32
    assert float((y.float() - want_y).abs().max()) <= ytol * float(want_y.abs().max())
    assert float((dx.float() - want_dx).abs().max()) <= ytol * float(want_dx.abs().max())
    assert float((db - want_db).abs().max()) <= dtol * float(want_db.abs().max())
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
