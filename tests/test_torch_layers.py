"""Port building blocks vs the JAX package: Dense, MLP, LayerNorm,
MultiHeadAttention, the sine position embedding and
normalize_2nd_moment. fp32, 1e-5 max-abs (rounding only: both sides do
the same fp32 arithmetic in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from layoutdetr_tpu.models import layers as jl
from layoutdetr_tpu.models.position_encoding import sine_position_embedding as jax_sine
from layoutdetr_tpu.models.stylegan2 import normalize_2nd_moment as jax_norm2
from layoutdetr_tpu_torch.models import layers as pl
from layoutdetr_tpu_torch.models.position_encoding import sine_position_embedding
from layoutdetr_tpu_torch.models.stylegan2 import normalize_2nd_moment
from layoutdetr_tpu_torch.utils.convert import JaxParams

from test_torch_common import assert_max_abs, load_port, randomize_tree, to_numpy_tree
from test_torch_common import one_torch_thread  # noqa: F401 (module-scoped autouse fixture)

TOL = 1e-5


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jax(module, *args, **kw):
    variables = module.init(jax.random.PRNGKey(0), *args, **kw)
    params = randomize_tree(to_numpy_tree(variables["params"]))
    return params, np.asarray(module.apply({"params": params}, *args, **kw))


def test_dense():
    x = _x(3, 5, 12)
    params, want = _jax(jl.Dense(7), x)
    c = JaxParams(params)
    c.dense("", "")
    port = load_port(pl.Dense(12, 7), c.finish())
    assert_max_abs(port(torch.from_numpy(x)), want, TOL, "Dense")


def test_mlp():
    x = _x(3, 5, 12)
    params, want = _jax(jl.MLP(10, 4, 3), x)
    c = JaxParams(params)
    c.mlp("", "")
    port = load_port(pl.MLP(12, 10, 4, 3), c.finish())
    assert_max_abs(port(torch.from_numpy(x)), want, TOL, "MLP")


def test_layernorm():
    x = _x(4, 6, 24) * 3 + 1
    params, want = _jax(jl.LayerNorm(eps=1e-12), x)
    c = JaxParams(params)
    c.layernorm("", "")
    port = load_port(pl.LayerNorm(24, eps=1e-12), c.finish())
    assert_max_abs(port(torch.from_numpy(x)), want, TOL, "LayerNorm")


@pytest.mark.parametrize("mode", ["self", "cross_padded"])
def test_multihead_attention(mode):
    q = _x(2, 5, 16, seed=1)
    kv = _x(2, 7, 16, seed=2)
    pad = np.zeros((2, 7), bool)
    pad[0, 4:] = True
    pad[1, :] = True  # every key padded: probabilities are zeroed, not NaN
    mha = jl.MultiHeadAttention(num_heads=4)
    if mode == "self":
        bias = jl.padding_bias(jnp.asarray(pad[:, :5]))
        params, want = _jax(mha, q, attn_bias=bias)
        args, kw = (torch.from_numpy(q),), {}
    else:
        bias = jl.padding_bias(jnp.asarray(pad))
        params, want = _jax(mha, q, kv + 1.0, kv, attn_bias=bias)
        args = (torch.from_numpy(q), torch.from_numpy(kv + 1.0), torch.from_numpy(kv))
    c = JaxParams(params)
    c.mha("", "")
    port = load_port(pl.MultiHeadAttention(16, 4), c.finish())
    tpad = torch.from_numpy(pad[:, :5] if mode == "self" else pad)
    got = port(*args, attn_bias=pl.padding_bias(tpad))
    assert torch.isfinite(got).all()
    assert_max_abs(got, want, TOL, f"MultiHeadAttention {mode}")


def test_padding_bias():
    pad = np.array([[False, True, True], [False, False, False]])
    got = pl.padding_bias(torch.from_numpy(pad))
    want = np.asarray(jl.padding_bias(jnp.asarray(pad)))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_sine_position_embedding():
    mask = np.zeros((2, 4, 5), bool)
    mask[1, :, 3:] = True
    mask[1, 3:, :] = True
    got = sine_position_embedding(torch.from_numpy(mask), num_pos_feats=8)
    want = np.asarray(jax_sine(jnp.asarray(mask), num_pos_feats=8))
    assert got.shape == want.shape == (2, 4, 5, 16)
    assert_max_abs(got, want, TOL, "sine position embedding")


def test_normalize_2nd_moment():
    z = _x(3, 9 * 4) * 2
    got = normalize_2nd_moment(torch.from_numpy(z))
    assert_max_abs(got, np.asarray(jax_norm2(jnp.asarray(z))), TOL, "normalize_2nd_moment")
