"""Text tokenization for the layout models — host-side, ahead of time.

A copy of ``layoutdetr_tpu/data/tokenizer.py``, so that the port imports
nothing of the JAX package; both give the same ids. Where JAX runs
``transformers``' ``BertTokenizerFast`` over a local vocab, the port runs
its own WordPiece (``WordPiece`` below, pure Python over the vocab file),
so a vocab gives the reference's ids on every host, ``transformers`` or
not; without a vocab the hash backend runs.

The reference tokenizes *inside every model forward* on CPU
(networks_detr.py:145, 289 via blip.init_tokenizer: BertTokenizer +
'[DEC]'/'[ENC]' special tokens, blip.py:190-195), which serializes the
GPU pipeline. Here tokenization happens once in the data pipeline and
models consume fixed-shape ``[B, N, T]`` id/mask tensors.

Backends:
- **WordPiece** when a local ``bert-base-uncased`` vocab is available
  (``vocab_dir``, else ``LAYOUTDETR_BERT_VOCAB``, else
  ``pretrained/bert-base-uncased``); bit-identical ids to the reference's
  ``BertTokenizerFast``.
- **Hash WordPiece fallback** (offline-safe): lowercase + punctuation
  split + whole-word hashing into the same 30522-id space with the same
  special-token layout (PAD=0, UNK=100, CLS=101, SEP=102, [DEC]=30522,
  [ENC]=30523). For from-scratch training this is equivalent — the
  embeddings are learned — and the id-space layout keeps checkpoints
  structurally compatible with converted HF weights.
"""

from __future__ import annotations

import functools
import hashlib
import os
import re
import unicodedata
from typing import Dict, List, Sequence

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


# The special tokens BertTokenizerFast registers for bert-base-uncased, in
# the order it adds them (unk, sep, pad, cls, mask, then blip.py's
# additional [DEC], [ENC]); each is matched whole in the raw text.
SPECIAL_TOKENS = ("[UNK]", "[SEP]", "[PAD]", "[CLS]", "[MASK]", "[DEC]", "[ENC]")
MAX_CHARS_PER_WORD = 100  # a longer word is one [UNK]
# CJK Unified Ideographs and their extensions: each such character is a word
_CJK_RANGES = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
               (0x2B740, 0x2B81F), (0x2B920, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


@functools.lru_cache(maxsize=None)
def _clean_char(c: str) -> str:
    """One raw character after BertNormalizer's text cleanup and CJK
    padding: NUL, U+FFFD and the control/format/unassigned/private
    characters (category C*, except tab, newline and return) go; white
    space (tab, newline, return and the Z* separators) becomes one space;
    a CJK ideograph is set apart by spaces."""
    if c in "\t\n\r":
        return " "
    cat = unicodedata.category(c)
    if c == "\ufffd" or cat[0] == "C":
        return ""
    if cat == "Zs" or c in "\u2028\u2029":
        return " "
    cp = ord(c)
    if any(lo <= cp <= hi for lo, hi in _CJK_RANGES):
        return f" {c} "
    return c


@functools.lru_cache(maxsize=None)
def _is_punctuation(c: str) -> bool:
    """BERT's punctuation: every non-alphanumeric printable ASCII
    character and the Unicode P* categories."""
    cp = ord(c)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(c).startswith("P")


def _lower(text: str) -> str:
    """Per-character lower case, as the Rust normalizer maps each char
    (str.lower would turn a final capital sigma into a final small one)."""
    if "\u03a3" not in text:
        return text.lower()
    return "".join(c.lower() for c in text)


class WordPiece:
    """``bert-base-uncased``'s tokenizer as ``BertTokenizerFast`` runs it,
    over a vocab file: the special tokens split off whole from the raw
    text; in the rest, text cleanup, CJK padding, NFD with the non-spacing
    marks dropped, lower case; split on white space and around each
    punctuation character; then each word greedily into the longest
    vocab pieces, continuations prefixed ``##``, a word of more than 100
    characters or with an unmatched rest becoming ``[UNK]``.
    ``encode`` adds ``[CLS]`` and ``[SEP]`` around at most
    ``max_length - 2`` tokens."""

    def __init__(self, vocab_file: str):
        try:
            with open(vocab_file, encoding="utf-8") as f:
                lines = f.read().split("\n")
        except (OSError, UnicodeDecodeError) as e:
            raise RuntimeError(f"cannot read the WordPiece vocab {vocab_file}: {e}") from e
        if lines and lines[-1] == "":
            lines.pop()
        self.vocab: Dict[str, int] = {}
        for i, tok in enumerate(lines):
            self.vocab[tok] = i  # a repeated token keeps its last line, as transformers' does
        self.specials: Dict[str, int] = {}
        next_id = len(self.vocab)
        for tok in SPECIAL_TOKENS:
            if tok in self.vocab:
                self.specials[tok] = self.vocab[tok]
            else:
                self.specials[tok] = next_id
                next_id += 1
        self.unk_id = self.specials["[UNK]"]
        self.cls_id, self.sep_id = self.specials["[CLS]"], self.specials["[SEP]"]
        self._split = re.compile("(" + "|".join(re.escape(t) for t in SPECIAL_TOKENS) + ")")
        self._word_ids = functools.lru_cache(maxsize=1 << 16)(self._word_ids_uncached)

    def _word_ids_uncached(self, word: str) -> tuple:
        if len(word) > MAX_CHARS_PER_WORD:
            return (self.unk_id,)
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            while end > start:
                piece = word[start:end] if start == 0 else "##" + word[start:end]
                hit = self.vocab.get(piece)
                if hit is not None:
                    ids.append(hit)
                    break
                end -= 1
            else:
                return (self.unk_id,)
            start = end
        return tuple(ids)

    def _words(self, text: str) -> List[str]:
        text = "".join(map(_clean_char, text))
        text = "".join(c for c in unicodedata.normalize("NFD", text)
                       if unicodedata.category(c) != "Mn")
        words = []
        for chunk in _lower(text).split(" "):
            word = ""
            for c in chunk:
                if _is_punctuation(c):
                    if word:
                        words.append(word)
                        word = ""
                    words.append(c)
                else:
                    word += c
            if word:
                words.append(word)
        return words

    def tokenize(self, text: str) -> List[int]:
        """The ids of ``text``, without ``[CLS]``/``[SEP]``."""
        ids: List[int] = []
        for i, part in enumerate(self._split.split(text)):
            if i % 2:  # a special token, matched as written
                ids.append(self.specials[part])
            elif part:
                for word in self._words(part):
                    ids.extend(self._word_ids(word))
        return ids

    def encode(self, text: str, max_length: int | None = None) -> List[int]:
        """``[CLS]`` + the ids (at most ``max_length - 2``) + ``[SEP]``."""
        ids = self.tokenize(text)
        if max_length is not None:
            ids = ids[: max(max_length - 2, 0)]
        return [self.cls_id] + ids + [self.sep_id]


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
        self._wordpiece = None
        vocab_dir = vocab_dir or os.environ.get(
            "LAYOUTDETR_BERT_VOCAB", os.path.join("pretrained", "bert-base-uncased")
        )
        vocab_file = os.path.join(vocab_dir, "vocab.txt")
        if os.path.exists(vocab_file):  # one that cannot be read raises
            self._wordpiece = WordPiece(vocab_file)

    @property
    def backend(self) -> str:
        return "wordpiece" if self._wordpiece is not None else "hash"

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
        if self._wordpiece is not None:
            return len(self._wordpiece.encode(text))
        return len(_WORD_RE.findall(text)) + 2

    def _encode_one(self, text: str) -> List[int]:
        if self._wordpiece is not None:
            return self._wordpiece.encode(text, self.max_length)
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
