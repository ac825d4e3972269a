"""Plain multi-head attention with the dropout keep mask of the program's
fused kernel, worked out again from the seed.

The kernel draws its keep mask in-kernel from Philox4x32-10 (Random123):
key (seed, b*H + h), counter (k // 4, q, 0, 0), word k % 4, keep where the
word is >= rate * 2^32. ``keep_mask`` draws the same bits with plain tensor
ops; ``attention`` is softmax attention in fp32 over an additive key bias.
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit halves of a * m, for a in [0, 2^32) held in int64;
    m split in 16-bit halves so that no product leaves int64."""
    p_lo = a * (m & 0xFFFF)
    p_hi = a * (m >> 16)
    s = p_lo + ((p_hi & 0xFFFF) << 16)
    return ((s >> 32) + (p_hi >> 16)) & _MASK32, s & _MASK32


def philox4x32(counter, key, rounds: int = 10):
    """Philox4x32-``rounds`` over uint32 words carried in int64 tensors that
    broadcast together: 4 counter words, 2 key words -> 4 output words."""
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


def keep_mask(seed: int, batch: int, heads: int, seq: int, rate: float, device=None):
    """[batch, heads, seq, seq] bool: True where the entry is kept."""
    groups = (seq + 3) // 4
    bh = (torch.arange(batch, device=device).view(batch, 1, 1, 1) * heads
          + torch.arange(heads, device=device).view(1, heads, 1, 1))
    q = torch.arange(seq, device=device).view(1, 1, seq, 1)
    grp = torch.arange(groups, device=device).view(1, 1, 1, groups)
    words = philox4x32((grp, q, 0, 0), (seed & _MASK32, bh))
    bits = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    bits = bits.reshape(batch, heads, seq, groups * 4)[..., :seq]
    return bits >= int(rate * 4294967296.0)


def attention(q, k, v, bias, scale: float, dropout_rate: float = 0.0, seed=None):
    """q, k, v [B, H, S, D]; bias [B, S] additive over the keys. Logits and
    softmax in fp32; with ``dropout_rate`` > 0 the probabilities are dropped
    by ``keep_mask(seed, ...)`` and the kept ones scaled by 1 / (1 - rate)."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(logits + bias[:, None, None, :], dim=-1)
    if dropout_rate > 0.0:
        b, h, s, _ = q.shape
        keep = keep_mask(int(seed) & _MASK32, b, h, s, dropout_rate, q.device)
        p = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype), v)
