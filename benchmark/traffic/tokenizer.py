"""Hash tokenization of the layout strings: a frozen copy of the hash
backend of the port's ``LayoutTokenizer`` (``data/tokenizer.py``), which
the port runs where no BERT vocab is present.

Lower case, words and single punctuation marks, each hashed by MD5 into
BERT's id space [999, 30522) between [CLS] (101) and [SEP] (102), padded
with 0 to ``max_length``; the character length of each string, clipped to
``length_clip - 1``, is the length feature.
"""

from __future__ import annotations

import functools
import hashlib
import re
from typing import Sequence

import numpy as np

PAD_ID, CLS_ID, SEP_ID = 0, 101, 102
_WORD_RE = re.compile(r"[a-z0-9]+|[^\sa-z0-9]", re.IGNORECASE)
_HASH_LO, _HASH_HI = 999, 30522


@functools.lru_cache(maxsize=1 << 14)
def _hash_token(tok: str) -> int:
    h = int.from_bytes(hashlib.md5(tok.encode("utf-8")).digest()[:4], "little")
    return _HASH_LO + (h % (_HASH_HI - _HASH_LO))


def encode(texts: Sequence[Sequence[str]], max_length: int, length_clip: int):
    """[B][N] strings -> ids [B, N, T] int32, mask [B, N, T] int32 (1 on
    tokens), char lengths [B, N] int32."""
    b, n = len(texts), len(texts[0])
    ids = np.full((b, n, max_length), PAD_ID, np.int32)
    mask = np.zeros((b, n, max_length), np.int32)
    lens = np.zeros((b, n), np.int32)
    for i, row in enumerate(texts):
        for j, s in enumerate(row):
            toks = [_hash_token(t.lower()) for t in _WORD_RE.findall(s)][: max_length - 2]
            enc = [CLS_ID] + toks + [SEP_ID]
            ids[i, j, : len(enc)] = enc
            mask[i, j, : len(enc)] = 1
            lens[i, j] = min(len(s), length_clip - 1)
    return ids, mask, lens
