"""The port's WordPiece (``layoutdetr_tpu_torch.data.tokenizer``) against the
JAX package's ``LayoutTokenizer``, which runs ``transformers``'
``BertTokenizerFast`` over the same vocab.

The vocab is synthetic, made from a seed: 30,522 lines with the real
special ids (0, 100-103), the ``[unused]`` bands, every single character
of the inputs' alphabet with its ``##`` continuation, and a few thousand
word pieces built from shared syllables, so that the greedy longest match
has several overlapping candidates at each step. The inputs are a few
hundred seeded strings: ad copy, punctuation runs, accents, CJK, emoji,
control and format characters, words over 100 characters, the special
tokens as written and in lower case, and lengths around ``max_length``.
The port's ids, masks and char lengths must be JAX's bit for bit, with
``transformers`` blocked on the port's side."""

import sys

import numpy as np
import pytest

from layoutdetr_tpu.data.tokenizer import LayoutTokenizer as JaxTokenizer
from layoutdetr_tpu_torch.data import tokenizer as port_tokenizer
from layoutdetr_tpu_torch.data.tokenizer import LayoutTokenizer

from test_torch_common import one_torch_thread  # noqa: F401 (module-scoped autouse fixture)

SYLLABLES = ("sum", "mer", "me", "r", "sa", "le", "shop", "ping", "ship", "now", "off", "ar",
             "ri", "val", "new", "lim", "it", "ed", "ing", "s", "un", "der", "es", "ti", "on",
             "free", "fre", "e", "a", "b", "ca", "fe", "ol", "de", "x", "qu", "z", "ab", "ba")
AD_WORDS = ("Summer", "sale", "up", "to", "50%", "off", "Shop", "now!", "FREE", "shipping",
            "new", "arrivals", "limited", "time", "only", "Café", "naïve", "résumé",
            "Ångström", "ΣΟΦΟΣ", "straße", "İstanbul", "夏季大促销", "限时", "特价", "🔥", "😀",
            "🛍️", "…", "—", "$9.99", "#1", "@brand", "e-mail", "don't", "U.S.A.", "x²",
            "½", "ＡＢＣ", "ﬁne", "Ⅻ")
ODD = ("\x00", "\x07", "\x0b", "\x1f", "\x7f", "\x85", "​", "‍", "﻿", "�",
       "\t", "\n", "\r", " ", " ", "　", "́", "")
SPECIAL = ("[DEC]", "[ENC]", "[MASK]", "[CLS]", "[SEP]", "[PAD]", "[UNK]", "[dec]", "[ENC",
           "[[DEC]]")
PUNCT = ("!!!", "...", "?!", "--", "()", "[]", "{}", "<>", "~~", "**", "''", '"', "/", "\\",
         "¡", "¿", "«»", "、", "。", "！")


def _vocab_lines(rng) -> list:
    """30,522 lines: bert-base-uncased's special ids and [unused] bands,
    the single characters and their ## forms, then seeded word pieces."""
    lines = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    lines += [f"[unused{i}]" for i in range(99, 994)]
    chars = sorted(set("".join(SYLLABLES) + "abcdefghijklmnopqrstuvwxyz0123456789"
                       + "!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~" + "夏季大促销限时特价σοφςß²½…—¡¿«»、。！"))
    pieces = list(chars) + ["##" + c for c in chars]
    pieces += list(SYLLABLES) + ["##" + s for s in SYLLABLES]
    words = set()
    while len(words) < 3000:
        k = int(rng.integers(2, 5))
        words.add("".join(rng.choice(SYLLABLES, size=k)))
    words = sorted(words)
    pieces += words[:2000] + ["##" + w for w in words[2000:]]
    pieces += ["summer", "sale", "shop", "shopping", "free", "shipping", "new", "arrivals",
               "limited", "time", "only", "cafe", "naive", "resume", "angstrom", "istanbul",
               "strasse", "brand", "mail", "don", "##t", "up", "to", "off", "now", "fine"]
    seen = set(lines)
    for p in pieces:
        if p not in seen:
            seen.add(p)
            lines.append(p)
    i = 0
    while len(lines) < 30522:
        lines.append(f"tok{i}")
        i += 1
    return lines


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("vocab")
    lines = _vocab_lines(np.random.default_rng(0))
    assert len(lines) == 30522 and lines[0] == "[PAD]" and lines[100:104] == [
        "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    (d / "vocab.txt").write_text("\n".join(lines) + "\n", encoding="utf-8")
    return str(d)


def _strings(n: int = 300, seed: int = 1) -> list:
    """Seeded strings over the categories of the module docstring."""
    rng = np.random.default_rng(seed)
    out = ["", " ", "Summer sale", "SHOP NOW!!!", "[DEC] hello [ENC]", "a" * 101, "ab" * 50,
           "x" * 100 + " y", "夏季大促销 up to 50% off", "\x00\x07​", "ΣΟΦΟΣ σοφός",
           "un" + "der" * 40 + "s", "Café…naïve—résumé", "🔥🔥 deal 🔥"]
    pools = (AD_WORDS, tuple(SYLLABLES), ODD, SPECIAL, PUNCT)
    weights = np.array([0.45, 0.25, 0.1, 0.05, 0.15])
    while len(out) < n:
        k = int(rng.integers(1, 40))
        parts = []
        for _ in range(k):
            pool = pools[int(rng.choice(len(pools), p=weights))]
            tok = str(pool[int(rng.integers(len(pool)))])
            if pool is SYLLABLES:
                tok = "".join(rng.choice(SYLLABLES, size=int(rng.integers(1, 6))))
                if rng.random() < 0.2:
                    tok = tok.upper() if rng.random() < 0.5 else tok.capitalize()
            if rng.random() < 0.03:
                tok = tok * int(rng.integers(20, 40))  # past 100 characters
            parts.append(tok)
            parts.append(str(rng.choice(["", " ", " ", " ", "  ", "\t", "\n"])))
        out.append("".join(parts))
    return out


@pytest.mark.parametrize("max_length", [16, 64])
def test_wordpiece_ids_match_bert_tokenizer_fast(vocab_dir, monkeypatch, max_length):
    """encode_batch, encode_layouts and token_count equal JAX's (which runs
    BertTokenizerFast) bit for bit; the port never needs transformers."""
    texts = _strings()
    ref = JaxTokenizer(max_length=max_length, vocab_dir=vocab_dir)
    assert ref.backend == "wordpiece" and ref._hf is not None
    monkeypatch.setitem(sys.modules, "transformers", None)
    port = LayoutTokenizer(max_length=max_length, vocab_dir=vocab_dir)
    assert port.backend == "wordpiece"

    got, want = port.encode_batch(texts), ref.encode_batch(texts)
    for g, w, what in zip(got, want, ("ids", "mask", "char_len")):
        assert g.dtype == w.dtype and g.shape == w.shape, what
        bad = np.flatnonzero((g != w).reshape(len(texts), -1).any(1))
        assert not len(bad), f"{what} differ on {[texts[i] for i in bad[:5]]}"
    rows = [texts[i:i + 9] for i in range(0, 270, 9)]
    for g, w in zip(port.encode_layouts(rows), ref.encode_layouts(rows)):
        np.testing.assert_array_equal(g, w)
    assert [port.token_count(s) for s in texts] == [ref.token_count(s) for s in texts]
    # the strings reach the cases they are meant to
    ids = got[0]
    assert (ids == 100).any() and (ids == 30522).any() and (ids == 30523).any()
    assert (got[1].sum(1) == max_length).sum() > 20  # truncated to max_length
    assert any(port.token_count(s) > max_length for s in texts)


def test_special_tokens_and_unknown_words(vocab_dir):
    """Special tokens split off whole as written; a word past 100
    characters, or with a rest no piece matches, is one [UNK]."""
    wp = LayoutTokenizer(max_length=64, vocab_dir=vocab_dir)._wordpiece
    v = wp.vocab
    assert wp.tokenize("[DEC]summer[ENC]") == [30522, v["summer"], 30523]
    assert wp.tokenize("a" * 100) == [v["a"]] + [v["##a"]] * 99
    assert wp.tokenize("a" * 101) == [100]
    assert wp.tokenize("summerü") == [v["summer"], v["##u"]]  # the accent is stripped
    assert wp.tokenize("summerλ") == [100]  # no piece for the rest
    assert wp.encode("sale " * 40, 8) == [101] + [v["sale"]] * 6 + [102]


def test_a_vocab_that_cannot_be_read_raises(tmp_path):
    """A vocab.txt that exists but does not read raises with its path; no
    vocab at all keeps the hash backend."""
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "vocab.txt").write_bytes(b"[PAD]\n\xff\xfe\n")
    with pytest.raises(RuntimeError, match=str(bad / "vocab.txt")):
        LayoutTokenizer(vocab_dir=str(bad))
    folder = tmp_path / "folder"
    (folder / "vocab.txt").mkdir(parents=True)
    with pytest.raises(RuntimeError, match="vocab.txt"):
        LayoutTokenizer(vocab_dir=str(folder))
    assert LayoutTokenizer(vocab_dir=str(tmp_path / "none")).backend == "hash"
    assert port_tokenizer.SPECIAL_TOKENS[-2:] == ("[DEC]", "[ENC]")
