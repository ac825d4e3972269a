"""Port attention vs the JAX package's, and the CUDA kernel vs its plain
version (on a card only).

JAX's Pallas kernel runs in interpret mode here, as tests/test_attention.py
runs it. Tolerances: 1e-5 max-abs in fp32 (rounding of two fp32 softmax
implementations), 2e-2 in bf16 (a bf16 ulp at |x| ~ 2..4 is 1.6e-2).
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from layoutdetr_tpu.ops import attention as jax_attention
from layoutdetr_tpu_torch.ops import _build, attention

from test_torch_common import assert_max_abs
from test_torch_common import one_torch_thread  # noqa: F401 (module-scoped autouse fixture)


def _inputs(b=2, h=3, s=16, d=8, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, h, s, d)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, s), np.float32)
    mask[0, 10:] = 0  # padded keys
    mask[-1, 2:] = 0  # CLS + SEP only, an empty string
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
    """The dropout form needs a seed and a rate in [0, 1)."""
    q, k, v, bias = _inputs()
    t = [torch.from_numpy(x) for x in (q, k, v, bias)]
    with pytest.raises(ValueError, match="seed"):
        attention.fused_attention(*t, scale=0.35, dropout_rate=0.1)
    with pytest.raises(ValueError):
        attention.fused_attention(*t, scale=0.35, dropout_rate=1.0, seed=1)


# ---------------------------------------------------------------------------
# the dropout form: Philox keep mask, shared by the kernel and the plain path
# ---------------------------------------------------------------------------

def test_philox_known_answers():
    """Random123's kat_vectors for philox4x32_10."""
    cases = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
             ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
             ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
              (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for counter, key, want in cases:
        assert tuple(int(w) for w in attention.philox4x32(counter, key)) == want


def test_keep_mask_layout_and_kept_fraction():
    mask = attention.keep_mask(123, 4, 3, 256, 0.1)
    assert mask.shape == (4, 3, 256, 256) and mask.dtype == torch.bool
    assert abs(mask.float().mean().item() - 0.9) < 2e-3
    # word k % 4 of the draw at counter (k // 4, q), key (seed, b*H + h)
    words = attention.philox4x32((5 // 4, 7, 0, 0), (123, 2 * 3 + 1))
    assert bool(mask[2, 1, 7, 5]) == (int(words[5 % 4]) >= attention.dropout_threshold(0.1))
    # no two (sequence, head) cells share a mask
    flat = mask.reshape(12, -1)
    assert all(not torch.equal(flat[i], flat[j]) for i in range(12) for j in range(i))


def test_dropout_cpu_path_is_attention_ref_with_the_mask():
    q, k, v, bias = (torch.from_numpy(x) for x in _inputs())
    got = attention.fused_attention(q, k, v, bias, scale=0.35, dropout_rate=0.1, seed=9)
    mask = attention.keep_mask(9, 2, 3, 16, 0.1)
    want = attention.attention_ref(q, k, v, bias, 0.35, 0.1, mask)
    assert torch.equal(got, want)
    p = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q, k) * 0.35 + bias[:, None, None], -1)
    manual = torch.einsum("bhqk,bhkd->bhqd", torch.where(mask, p / 0.9, 0.0), v)
    assert_max_abs(got, manual.numpy(), 1e-5, "dropout vs masked softmax")


def test_dropout_seeds():
    """Same seed, same output; another seed, another output; finite, and
    unlike the deterministic output (the statistics of
    tests/test_attention.py:36-60, rate 0.5)."""
    q, k, v, bias = (torch.from_numpy(x) for x in _inputs(b=1, h=2, s=32, d=8, seed=1))
    run = lambda seed: attention.fused_attention(q, k, v, bias, scale=0.35, dropout_rate=0.5,
                                                 seed=seed)
    out, ref = run(123), attention.attention_ref(q, k, v, bias, 0.35)
    assert torch.isfinite(out).all() and not torch.allclose(out, ref)
    assert abs(out.mean().item() - ref.mean().item()) < 0.35
    assert torch.equal(out, run(123))
    assert not torch.equal(out, run(124))


def test_dropout_mean_over_seeds_is_unbiased():
    """Inverted dropout keeps the expectation: the mean over 400 seeds of
    the output is the deterministic output. Each entry's spread is about
    sqrt(rate / (1 - rate) / n_seeds) times the size of its p.v terms, so
    the bar is 5 standard errors; a row sum that skipped dropped keys
    (the online-softmax trap) would bias it by ~rate."""
    q, k, v, bias = (torch.from_numpy(x) for x in _inputs(b=1, h=2, s=32, d=8, seed=2))
    ref = attention.attention_ref(q, k, v, bias, 0.35)
    outs = torch.stack([attention.fused_attention(q, k, v, bias, scale=0.35, dropout_rate=0.1,
                                                  seed=s) for s in range(400)])
    err = (outs.mean(0) - ref).abs().max().item()
    se = (outs.std(0) / 20.0).max().item()
    assert err <= 5 * se, (err, se)
    assert abs(outs.mean().item() - ref.mean().item()) < 0.02


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


# ---------------------------------------------------------------------------
# the wrapper's plan (pure Python: the geometry the kernels are handed)
# ---------------------------------------------------------------------------

def _bthd(b, t, h, dtype=torch.bfloat16):
    """A [B,T,H,D] projection viewed as [B,H,T,D], as BERT hands it over."""
    return torch.zeros(b, t, h, 192, dtype=dtype).transpose(1, 2)


def test_plan_of_the_strided_view():
    q = _bthd(18, 77, 4)
    plan = attention._check(q, q, q, torch.zeros(18, 77), scale=0.125, dropout_rate=0.1)
    assert plan.body == "bf16"
    # dims (D, H, T, B) with the view's byte strides: head 384, row 4 * 384
    want = attention.MapGeometry((192, 4, 77, 18), (384, 1536, 77 * 1536), (1, 2, 3))
    assert plan.maps == (want,) * 4  # o = empty_like(q) keeps q's layout
    p = plan.params
    assert (p.dtype, p.batch, p.heads, p.seq, p.head_dim, p.dropout) == (1, 18, 4, 77, 192, 1)
    assert p.scale == pytest.approx(0.125) and p.inv_keep == pytest.approx(1 / 0.9)
    assert p.threshold == attention.dropout_threshold(0.1)
    assert list(p.strides) == [77 * 4 * 192, 192, 4 * 192] * 4
    assert [tuple(p.maps[0].dims), tuple(p.maps[0].strides)] == [want.dims, want.strides]
    assert (p.maps[3].pos_h, p.maps[3].pos_t, p.maps[3].pos_b) == (1, 2, 3)
    assert plan.addr == ctypes.addressof(plan.params)


@pytest.mark.parametrize("shape,want", [
    ((2, 4, 256, 192), attention.MapGeometry((192, 256, 4, 2), (384, 256 * 384, 4 * 256 * 384),
                                             (2, 1, 3))),
    # dims of size 1 are never stepped: last, with a stride past the others
    ((1, 4, 1, 192), attention.MapGeometry((192, 4, 1, 1), (384, 1536, 1536), (1, 2, 3))),
    ((3, 1, 64, 192), attention.MapGeometry((192, 64, 3, 1), (384, 64 * 384, 3 * 64 * 384),
                                            (3, 1, 2))),
])
def test_map_geometry_of_contiguous_and_trivial_dims(shape, want):
    got = attention.map_geometry(attention.Spec.of(torch.zeros(shape, dtype=torch.bfloat16)))
    assert got == want
    assert all(st % 16 == 0 for st in got.strides)


def test_plan_fp32_has_no_maps():
    q = _bthd(2, 200, 4, torch.float32)
    plan = attention._check(q, q, q, torch.zeros(2, 200))
    assert plan.body == "fp32" and plan.maps == ()
    assert plan.params.dropout == 0 and plan.params.inv_keep == 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_refuses_rows_not_16_byte_aligned(dtype):
    q = torch.zeros(2, 16, 4, 194, dtype=dtype)[..., :192].transpose(1, 2)  # head stride 194
    with pytest.raises(ValueError, match="16-byte"):
        attention._check(q, q, q, torch.zeros(2, 16))
    # a dim of size 1 may have any stride: it is never stepped
    one = torch.zeros(4 * 192, dtype=dtype).as_strided((1, 4, 1, 192), (999, 192, 7, 1))
    attention._check(one, one, one, torch.zeros(1, 1))


def test_plans_are_cached_per_signature():
    q = _bthd(2, 64, 4)
    bias = torch.zeros(2, 64)
    a = attention._check(q, q, q, bias, scale=0.5)
    assert attention._check(_bthd(2, 64, 4), q, q, torch.ones(2, 64), scale=0.5) is a
    assert attention._check(q, q, q, bias, scale=0.25) is not a
    assert attention._check(q.contiguous(), q, q, bias, scale=0.5) is not a


def _c_struct_fields(src: str, name: str):
    body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip().rstrip(";")
        if not line:
            continue
        ctype, names = re.match(r"(unsigned|long long|cuuint64_t|\w+)\s+(.*)", line).groups()
        for n in names.split(","):
            m = re.match(r"(\w+)((?:\[\d+\])*)", n.strip())
            count = 1
            for dim in re.findall(r"\d+", m.group(2)):
                count *= int(dim)
            fields.append((m.group(1), ctype, count))
    return fields


def test_params_structure_matches_the_c_struct():
    """Field for field, and so byte for byte: ``_lib()`` also checks the
    size against the built library's on the card."""
    src = open(os.path.join(_build.CSRC, "attention.cu")).read()
    ctypes_of = {"int": ctypes.c_int, "float": ctypes.c_float, "unsigned": ctypes.c_uint,
                 "long long": ctypes.c_longlong, "cuuint64_t": ctypes.c_uint64,
                 "MapGeom": attention._MapGeom}
    for name, cls in (("MapGeom", attention._MapGeom), ("Params", attention._Params)):
        fields = _c_struct_fields(src, name)
        got = []
        for fname, ftype in cls._fields_:
            count = getattr(ftype, "_length_", 1)
            base = getattr(ftype, "_type_", ftype) if count > 1 else ftype
            got.append((fname, base, count))
        want = [(n, ctypes_of[t], c) for n, t, c in fields]
        assert got == want, name
    assert ctypes.sizeof(attention._Params) == 432


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card_inputs(b, h, t, dtype, layout, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if layout == "contiguous":
        q, k, v = (torch.randn(b, h, t, 192, device="cuda", generator=g).to(dtype) for _ in range(3))
    else:  # [B, T, H, D] projections viewed as [B, H, T, D], as BERT gives them
        q, k, v = (torch.randn(b, t, h, 192, device="cuda", generator=g).to(dtype).transpose(1, 2)
                   for _ in range(3))
    lens = torch.randint(2, t + 2, (b,), device="cuda", generator=g).clamp(max=t)
    lens[0] = min(2, t)
    bias = torch.where(torch.arange(t, device="cuda")[None] < lens[:, None], 0.0, -10000.0)
    if b > 1 and t > 2:  # a row whose only unmasked keys are the last two
        bias[1] = -10000.0
        bias[1, -2:] = 0.0
    return q, k, v, bias


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("t", [1, 16, 63, 64, 65, 77, 128, 200, 256])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("layout,b,h", [("strided", 18, 4), ("contiguous", 18, 4),
                                        ("strided", 3, 1)])
def test_kernel_matches_plain_on_card(dtype, tol, t, rate, layout, b, h):
    """fp32 on the CUDA cores, bf16 on the tensor cores; bf16 is held
    against the fp32 plain version of the same bf16 values, to 2e-2 (the
    bf16 spacing of outputs up to 4). With dropout both sides drop the same
    Philox-drawn entries, and the bar grows with max |o| / 4 where the
    1 / (1 - rate) scaling makes outputs larger. [3, 1] heads give 3
    (sequence, head) pairs: fewer tiles than SMs, one head a map dim of
    size 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, bias = _card_inputs(b, h, t, dtype, layout, t)
    before = dict(attention.LAUNCHES)
    got = attention.fused_attention(q, k, v, bias, scale=192 ** -0.5, dropout_rate=rate,
                                    seed=77 if rate else None)
    torch.cuda.synchronize()
    form = "fused_attention_dropout" if rate else "fused_attention"
    assert attention.LAUNCHES == dict(before, **{form: before[form] + 1})
    mask = attention.keep_mask(77, b, h, t, rate, device="cuda") if rate else None
    want = attention.attention_ref(q.float(), k.float(), v.float(), bias, 192 ** -0.5, rate, mask)
    assert got.dtype == dtype and got.shape == q.shape and got.stride() == q.stride()
    if rate:
        tol = tol * max(1.0, float(want.abs().max()) / 4.0)
    assert_max_abs(got, want.cpu().numpy(), tol, f"kernel {dtype} T={t} rate={rate} {layout}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_kernel_gives_the_same_bits_twice_on_card(dtype, rate):
    """No atomics and no order that depends on the schedule: two launches
    on the same inputs agree bit for bit (T=200: a ragged last chunk)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, bias = _card_inputs(18, 4, 200, dtype, "strided", 5)
    run = lambda: attention.fused_attention(q, k, v, bias, scale=0.07, dropout_rate=rate,
                                            seed=3 if rate else None)
    first = run()
    torch.cuda.synchronize()
    assert torch.equal(first, run())


@pytest.mark.cuda
def test_params_size_matches_the_library_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    attention._lib()  # raises if the sizes differ
    assert _build.load("attention").layoutdetr_attention_params_size() == ctypes.sizeof(
        attention._Params)


def _heads_share(device, dtype, t):
    """The whole-head dropout pass and two TP ranks' passes over heads
    [0, 2) and [2, 4) of 4 (``head_offset``, ``total_heads``)."""
    g = torch.Generator(device=device).manual_seed(t)
    q, k, v = (torch.randn(6, 4, t, 192, device=device, generator=g).to(dtype) for _ in range(3))
    bias = torch.zeros(6, t, device=device)
    run = lambda sl, **kw: attention.fused_attention(
        q[:, sl], k[:, sl], v[:, sl], bias, scale=192 ** -0.5, dropout_rate=0.1, seed=9, **kw)
    whole = run(slice(0, 4))
    parts = [run(slice(o, o + 2), head_offset=o, total_heads=4) for o in (0, 2)]
    return whole, parts


@pytest.mark.parametrize("t", [16, 65])
def test_dropout_of_a_tp_rank_heads_is_the_whole_pass_slice(t):
    """A rank that holds heads [o, o + 2) of 4 keys its mask by the global
    head, so it drops what one pass over all heads drops there."""
    whole, parts = _heads_share("cpu", torch.float32, t)
    for o, part in zip((0, 2), parts):
        assert torch.equal(part, whole[:, o:o + 2])
    with pytest.raises(ValueError, match="do not lie in"):
        attention.make_plan(*(attention.Spec((1, 2, 8, 192), (3072, 1536, 192, 1),
                                             torch.float32),) * 4,
                            attention.Spec((1, 8), (8, 1), torch.float32), 1.0, 0.1,
                            head_offset=3, total_heads=4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [16, 65, 256])
def test_dropout_of_a_tp_rank_heads_is_the_whole_pass_slice_on_card(dtype, t):
    """The same on the card, both bodies: bit for bit (each (sequence,
    head) is computed alone, in the same order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    whole, parts = _heads_share("cuda", dtype, t)
    for o, part in zip((0, 2), parts):
        assert torch.equal(part, whole[:, o:o + 2])
