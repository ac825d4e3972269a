"""Text tokenization for the layout models — host-side, ahead of time.

A copy of ``layoutdetr_tpu/data/tokenizer.py``, so that the port imports
nothing of the JAX package; both give the same ids. ``transformers`` is
imported only when a local vocab is present; without it the hash
backend runs.

The reference tokenizes *inside every model forward* on CPU
(networks_detr.py:145, 289 via blip.init_tokenizer: BertTokenizer +
'[DEC]'/'[ENC]' special tokens, blip.py:190-195), which serializes the
GPU pipeline. Here tokenization happens once in the data pipeline and
models consume fixed-shape ``[B, N, T]`` id/mask tensors.

Backends:
- **HF WordPiece** when a local ``bert-base-uncased`` vocab is available
  (checked in ``pretrained/bert-base-uncased`` and the HF cache);
  bit-identical ids to the reference.
- **Hash WordPiece fallback** (offline-safe): lowercase + punctuation
  split + whole-word hashing into the same 30522-id space with the same
  special-token layout (PAD=0, UNK=100, CLS=101, SEP=102, [DEC]=30522,
  [ENC]=30523). For from-scratch training this is equivalent — the
  embeddings are learned — and the id-space layout keeps checkpoints
  structurally compatible with converted HF weights.
"""

from __future__ import annotations

import hashlib
import os
import re
from typing import List, Sequence

import numpy as np

PAD_ID = 0
UNK_ID = 100
CLS_ID = 101
SEP_ID = 102
BASE_VOCAB = 30522
DEC_ID = 30522  # bos for the text decoder ([DEC], blip.py:192)
ENC_ID = 30523  # [ENC]
VOCAB_SIZE = 30524

_WORD_RE = re.compile(r"[a-z0-9]+|[^\sa-z0-9]", re.IGNORECASE)
# ids 0-999 are BERT's unused/special band; hash into [999, 30522).
_HASH_LO, _HASH_HI = 999, BASE_VOCAB


def _hash_token(tok: str) -> int:
    h = int.from_bytes(hashlib.md5(tok.encode("utf-8")).digest()[:4], "little")
    return _HASH_LO + (h % (_HASH_HI - _HASH_LO))


class LayoutTokenizer:
    """Tokenizer with the reference's special-token layout.

    encode_batch(texts [B][N] or flat [M]) -> ids, mask, lengths (int32).
    """

    def __init__(self, max_length: int = 256, vocab_dir: str | None = None,
                 length_clip: int | None = None):
        self.max_length = max_length
        # Char-length clip bound for the text_len feature. The reference
        # indexes its nn.Embedding(max_text_length) with the RAW
        # unclipped len(t) (networks_detr.py:149) and would crash on a
        # >= 256-char string; clipping at table_size-1 here is a
        # deliberate safety deviation that matches the reference on every
        # input the reference itself survives. When the token dimension
        # is auto-bucketed below 256 the clip must stay at the model's
        # text_len_table so the length-embedding indexes are unchanged.
        # Defaults to max_length (the reference's table size).
        self.length_clip = max_length if length_clip is None else length_clip
        self.bos_token_id = DEC_ID
        self.pad_token_id = PAD_ID
        self.vocab_size = VOCAB_SIZE
        self._hf = None
        vocab_dir = vocab_dir or os.environ.get(
            "LAYOUTDETR_BERT_VOCAB", os.path.join("pretrained", "bert-base-uncased")
        )
        vocab_file = os.path.join(vocab_dir, "vocab.txt")
        if os.path.isfile(vocab_file):
            try:
                from transformers import BertTokenizerFast

                self._hf = BertTokenizerFast(vocab_file=vocab_file)
                self._hf.add_special_tokens({"additional_special_tokens": ["[DEC]", "[ENC]"]})
            except Exception:
                self._hf = None

    @property
    def backend(self) -> str:
        return "wordpiece" if self._hf is not None else "hash"

    def require_hf_for_checkpoint(self, ckpt_path: str) -> None:
        """Refuse to pair the hash fallback with converted-torch params.

        Converted checkpoints (torch_convert writes a
        ``<ckpt>.converted.json`` sidecar) embed BERT weights indexed by
        real HF WordPiece ids; the offline hash fallback produces
        different ids, so evaluation would silently compute garbage.
        Fail loudly instead.
        """
        import json as _json

        if self.backend != "hash":
            return  # real WordPiece ids — the guard is irrelevant
        sidecar = str(ckpt_path) + ".converted.json"
        converted = False
        if str(ckpt_path).endswith(".pkl"):
            # Reference snapshot pickles always carry HF-trained BERT
            # weights (networks_detr.py:92 from_pretrained).
            converted = True
        elif os.path.isfile(sidecar):
            with open(sidecar) as f:
                meta = _json.load(f)
            converted = meta.get("hf_token_ids", True)
        if converted:
            raise RuntimeError(
                f"checkpoint {ckpt_path} was converted from torch and "
                "expects HF WordPiece token ids, but no bert-base-uncased "
                "vocab.txt is available (hash-tokenizer fallback active). "
                "Point LAYOUTDETR_BERT_VOCAB at a directory containing "
                "vocab.txt."
            )

    def token_count(self, text: str) -> int:
        """Token count (incl. CLS/SEP) of ``text``, uncapped by max_length.

        Used by ``--max-text-length auto`` to measure a dataset's true
        max token length before choosing the static T bucket.
        """
        if self._hf is not None:
            return len(self._hf.encode(text, truncation=False))
        return len(_WORD_RE.findall(text)) + 2

    def _encode_one(self, text: str) -> List[int]:
        if self._hf is not None:
            return self._hf.encode(text, truncation=True, max_length=self.max_length)
        toks = [_hash_token(t.lower()) for t in _WORD_RE.findall(text)]
        toks = toks[: self.max_length - 2]
        return [CLS_ID] + toks + [SEP_ID]

    def encode_batch(self, texts: Sequence[str]):
        """Flat list of strings -> (ids [M, T], mask [M, T], char_len [M])."""
        m = len(texts)
        t = self.max_length
        ids = np.full((m, t), PAD_ID, np.int32)
        mask = np.zeros((m, t), np.int32)
        lens = np.zeros((m,), np.int32)
        for i, s in enumerate(texts):
            enc = self._encode_one(s)
            ids[i, : len(enc)] = enc
            mask[i, : len(enc)] = 1
            # Reference uses the raw unclipped character length as an
            # embedding index (networks_detr.py:149, OOB for >= table-size
            # strings); clipping to table size is a safety deviation.
            lens[i] = min(len(s), self.length_clip - 1)
        return ids, mask, lens

    def encode_layouts(self, texts_per_layout: Sequence[Sequence[str]]):
        """[B][N] strings -> (ids [B, N, T], mask [B, N, T], len [B, N])."""
        b = len(texts_per_layout)
        n = len(texts_per_layout[0]) if b else 0
        flat = [s for row in texts_per_layout for s in row]
        ids, mask, lens = self.encode_batch(flat)
        return ids.reshape(b, n, -1), mask.reshape(b, n, -1), lens.reshape(b, n)
