"""Port attention vs the JAX package's, and the CUDA kernel vs its plain
version (on a card only).

JAX's Pallas kernel runs in interpret mode here, as tests/test_attention.py
runs it. Tolerances: 1e-5 max-abs in fp32 (rounding of two fp32 softmax
implementations), 2e-2 in bf16 (a bf16 ulp at |x| ~ 2..4 is 1.6e-2).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from layoutdetr_tpu.ops import attention as jax_attention
from layoutdetr_tpu_torch.ops import attention

from test_torch_common import assert_max_abs


def _inputs(b=2, h=3, s=16, d=8, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, h, s, d)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, s), np.float32)
    mask[0, 10:] = 0  # padded keys
    mask[1, 2:] = 0  # CLS + SEP only, an empty string
    bias = (1.0 - mask) * -10000.0
    return q, k, v, bias


def _port(q, k, v, bias, dtype=torch.float32):
    scale = 1.0 / np.sqrt(q.shape[-1])
    tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    return attention.fused_attention(tq, tk, tv, torch.from_numpy(bias), scale=scale)


def test_attention_ref_matches_jax_ref_and_kernel_fp32():
    q, k, v, bias = _inputs()
    scale = 1.0 / np.sqrt(q.shape[-1])
    want_ref = np.asarray(jax_attention.attention_ref(q, k, v, jnp.asarray(bias), scale))
    want_kernel = np.asarray(jax_attention.fused_attention(
        q, k, v, jnp.asarray(bias), scale=scale, interpret=True))
    got = attention.attention_ref(*(torch.from_numpy(x) for x in (q, k, v, bias)), scale)
    assert_max_abs(got, want_ref, 1e-5, "attention_ref vs JAX attention_ref")
    assert_max_abs(got, want_kernel, 1e-5, "attention_ref vs JAX fused_attention")
    # on a CPU tensor the wrapper is the plain version
    assert torch.equal(_port(q, k, v, bias), got)


def test_attention_bf16_matches_jax():
    q, k, v, bias = _inputs()
    scale = 1.0 / np.sqrt(q.shape[-1])
    qb, kb, vb = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    want_kernel = np.asarray(jax_attention.fused_attention(
        qb, kb, vb, jnp.asarray(bias), scale=scale, interpret=True)).astype(np.float32)
    want_ref = np.asarray(jax_attention.attention_ref(q, k, v, jnp.asarray(bias), scale))
    got = _port(q, k, v, bias, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert_max_abs(got, want_kernel, 2e-2, "bf16 vs JAX fused_attention bf16")
    assert_max_abs(got, want_ref, 2e-2, "bf16 vs JAX attention_ref fp32")


def test_padded_keys_get_no_weight():
    q, k, v, bias = _inputs()
    v2 = v.copy()
    v2[0, :, 10:] = 1e3  # values behind padded keys must not leak
    v2[1, :, 2:] = 1e3
    assert_max_abs(_port(q, k, v2, bias), _port(q, k, v, bias).numpy(), 1e-5, "padded keys")


def test_dropout_raises():
    q, k, v, bias = _inputs()
    t = [torch.from_numpy(x) for x in (q, k, v, bias)]
    with pytest.raises(NotImplementedError):
        attention.fused_attention(*t, scale=0.35, dropout_rate=0.1)


@pytest.mark.parametrize("case", ["dtype", "mixed_dtype", "head_dim", "bias_shape", "bias_dtype",
                                  "strided_head_dim", "misaligned_rows", "misaligned_start"])
def test_wrapper_checks_raise(case):
    q = torch.zeros(2, 4, 16, 192)
    k, v = q.clone(), q.clone()
    bias = torch.zeros(2, 16)
    if case == "dtype":
        q = k = v = q.half()
    elif case == "mixed_dtype":
        k = k.bfloat16()
    elif case == "head_dim":
        q = k = v = torch.zeros(2, 4, 16, 96)
    elif case == "bias_shape":
        bias = torch.zeros(2, 15)
    elif case == "bias_dtype":
        bias = bias.bfloat16()
    elif case == "strided_head_dim":
        q = torch.zeros(2, 4, 16, 192 * 2)[..., ::2]
    elif case == "misaligned_rows":
        q = torch.zeros(2, 4, 16, 193)[..., :192]  # row stride 193 floats
    else:
        q = torch.zeros(2 * 4 * 16 * 192 + 1)[1:].view(2, 4, 16, 192)  # starts 4 bytes in
    with pytest.raises((TypeError, ValueError)):
        attention._check(q, k, v, bias)


def test_wrapper_checks_accept_strided_heads():
    # [B,S,H,D] projection viewed as [B,H,S,D]: no copy needed
    q = torch.zeros(2, 16, 4, 192).transpose(1, 2)
    attention._check(q, q, q, torch.zeros(2, 16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("t", [1, 64, 77, 256])
def test_kernel_matches_plain_on_card(dtype, tol, t):
    """fp32 on the CUDA cores, bf16 on the tensor cores; bf16 is held
    against the fp32 plain version of the same bf16 values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(t)
    b, h, d = 18, 4, 192
    q, k, v = (torch.randn(b, t, h, d, device="cuda", generator=g).to(dtype).transpose(1, 2)
               for _ in range(3))
    lens = torch.randint(2, t + 2, (b,), device="cuda", generator=g).clamp(max=t)
    lens[0] = min(2, t)
    bias = torch.where(torch.arange(t, device="cuda")[None] < lens[:, None], 0.0, -10000.0)
    before = attention.fused_attention.launches
    got = attention.fused_attention(q, k, v, bias, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert attention.fused_attention.launches == before + 1
    want = attention.attention_ref(q.float(), k.float(), v.float(), bias, d ** -0.5)
    assert got.dtype == dtype and got.shape == q.shape
    assert_max_abs(got, want.cpu().numpy(), tol, f"kernel {dtype} T={t}")
