"""The port's CLIP BPE tokenizer and vocabulary against the JAX package's.

`dldkd_tpu_torch.tools.clip_tokenizer` splits words without the `regex`
module. Held here: its character classes against `regex`'s over every
code point (the only differences are the C9 code points, pinned below),
and ids, `tokenize` arrays and `decode` equal to `dldkd_tpu`'s on a
seeded corpus of 320 strings. `data/vocab.py` is held bitwise on a
synthetic word2vec BigFile.
"""

import filecmp
import unicodedata

import numpy as np
import pytest
import regex

from dldkd_tpu.data import vocab as jax_vocab
from dldkd_tpu.tools import clip_tokenizer as jax_tok
from dldkd_tpu_torch.data import vocab as port_vocab
from dldkd_tpu_torch.data.bigfile import BigFileWriter
from dldkd_tpu_torch.tools import clip_tokenizer as port_tok

ALL_CHARS = "".join(chr(i) for i in range(0x110000)
                    if not 0xD800 <= i < 0xE000)

# code points a newer Unicode made letters / numbers, unassigned in
# Python's unicodedata 15.0 (ROADMAP C9): Todhri (16.0), CJK extension I
# (15.1), Garay digits (16.0)
C9_LETTERS = ("\U000105c0", "\U0002ebf0")
C9_NUMBERS = ("\U00010d40",)


@pytest.fixture(scope="module")
def tokenizers():
    return jax_tok.ClipTokenizer(), port_tok.ClipTokenizer()


def _corpus(n: int = 320, seed: int = 0):
    """Seeded strings from pieces of every kind the tokenizer splits."""
    pieces = [
        # ASCII captions and upper-case contractions
        "a man is talking to a woman", "The QUICK brown fox", "IT'S",
        "don't", "We'LL", "they'RE", "I'M", "you'VE", "he'D", "o'clock",
        "rock'n'roll", "'s", "''", "SHE'S HERE",
        # digit and punctuation runs
        "12345", "3.14", "1,000,000", "2024-10-17", "!!!", "?!", "...",
        "#$%^&*()", "--", "'''", "@user", "__init__", "a/b\\c", "~`|",
        # accented Latin, Greek, CJK, emoji, combining marks
        "café", "naïve", "résumé", "über", "ÉCOLE", "Ångström",
        "ſtraße", "ſ's", "αβγ", "Ωμέγα", "ΣΊΣΥΦΟΣ", "日本語のテキスト",
        "中文字符", "한국어", "カタカナ", "😀", "🚀🔥", "👍🏽", "🇯🇵",
        "❤\ufe0f", "e\u0301", "a\u0308b", "n\u0303o", "\u0345", "ι\u0345ς",
        "x\u20dd", "Ⅻ", "½", "٣٤", "१२",
        # entities
        "&amp;", "&amp;amp;", "&lt;tag&gt;", "&#39;", "&quot;hi&quot;",
        "&nbsp;", "&copy;2024",
        # the special tokens
        "<|endoftext|>", "<|StartOfText|>", "<|ſtartoftext|>", "<|end",
    ]
    spaces = [" ", "  ", "\t", "\n", "\u00a0", "\u3000", "\x1c", "\x1d\x1e",
              "\x1f", " \u2003 ", "\r\n", ""]
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        k = rng.randint(2, 16) if i % 10 else rng.randint(40, 120)
        parts = []
        for _ in range(k):
            parts.append(pieces[rng.randint(len(pieces))])
            parts.append(spaces[rng.randint(len(spaces))])
        out.append("".join(parts))
    return out


def test_merge_table_is_the_jax_packages():
    assert filecmp.cmp(jax_tok.VOCAB_PATH, port_tok.VOCAB_PATH,
                       shallow=False)


def test_character_classes_match_regex():
    """Space, letter and number per code point, as `regex`'s
    case-insensitive classes give them; where `regex` knows a letter or
    number that unicodedata leaves unassigned (C9), the port has 'O'."""
    ignore = regex.IGNORECASE
    letters = set(regex.findall(r"[\p{L}]", ALL_CHARS, ignore))
    numbers = set(regex.findall(r"[\p{N}]", ALL_CHARS, ignore))
    others = set(regex.findall(r"[^\s\p{L}\p{N}]", ALL_CHARS, ignore))
    kind = port_tok._kind.__wrapped__
    c9 = []
    for c in ALL_CHARS:
        want = ("L" if c in letters else "N" if c in numbers
                else "O" if c in others else "S")
        got = kind(c)
        if got != want:
            assert want in "LN" and got == "O" \
                and unicodedata.category(c) == "Cn", (hex(ord(c)), want, got)
            c9.append(c)
    assert "\u0345" not in letters | numbers | others
    spaces = set(regex.findall(r"\s", ALL_CHARS))
    assert {c for c in ALL_CHARS if port_tok._is_space(c)} == spaces
    assert set("".join(port_tok._SPACE_RUN.findall(ALL_CHARS))) == spaces
    assert set(C9_LETTERS + C9_NUMBERS) <= set(c9)


def test_literals_fold_as_regex():
    """The specials' and contractions' letters match case-insensitively
    exactly the characters `regex` folds onto them."""
    letters = "".join(sorted(set("".join(port_tok._SPECIALS
                                         + port_tok._CONTRACTIONS))
                             - set("<|>'")))
    folded = set(regex.findall(f"[{letters}]", ALL_CHARS, regex.IGNORECASE))
    assert folded == {c for c in ALL_CHARS
                      if c.translate(port_tok._FOLD) in letters}


def test_c9_code_points_pinned():
    """The documented difference: a code point unassigned in unicodedata
    15.0 that `regex` classes as a letter or number is a run of other
    symbols in the port, so it splits from the letters around it."""
    for c in C9_LETTERS + C9_NUMBERS:
        assert unicodedata.category(c) == "Cn"
    for c in C9_LETTERS:
        assert jax_tok._WORD_PAT.findall(f"a{c}b") == [f"a{c}b"]
        assert port_tok._words(f"a{c}b") == ["a", c, "b"]
    for c in C9_NUMBERS:
        assert jax_tok._WORD_PAT.findall(f"!{c}!") == ["!", c, "!"]
        assert port_tok._words(f"!{c}!") == [f"!{c}!"]


def test_corpus_has_no_c9_code_points():
    """The parity corpus below is held equal everywhere: it holds no
    unassigned code point (the C9 ones are pinned above)."""
    text = "".join(_corpus())
    assert not any(unicodedata.category(c) == "Cn" for c in set(text))


def test_word_splits_match_regex():
    for text in _corpus():
        assert port_tok._words(text) == jax_tok._WORD_PAT.findall(text), text
        assert port_tok._clean(text) == jax_tok._clean(text), text


def test_encode_and_decode_match(tokenizers):
    theirs, ours = tokenizers
    for text in _corpus():
        ids = theirs.encode(text)
        assert ours.encode(text) == ids, text
        assert ours.decode(ids) == theirs.decode(ids), text


def test_tokenize_arrays_match(tokenizers):
    theirs, ours = tokenizers
    texts = _corpus()
    want, got = theirs.tokenize(texts), ours.tokenize(texts)
    for key in ("input_ids", "attention_mask"):
        assert got[key].dtype == want[key].dtype == np.int32
        np.testing.assert_array_equal(got[key], want[key])
    # the long strings truncate at 77, keeping the end-of-text id
    full = got["attention_mask"].sum(1) == 77
    assert full.sum() >= 20
    assert (got["input_ids"][full, 76] == ours.eot_id).all()


def test_vocab_layout(tokenizers):
    theirs, ours = tokenizers
    assert ours.encoder == theirs.encoder
    assert (ours.sot_id, ours.eot_id) == (49406, 49407)


@pytest.fixture()
def w2v_dir(tmp_path):
    rng = np.random.RandomState(3)
    words = [f"w{i}" for i in range(12)] + ["é"]
    with BigFileWriter(str(tmp_path / "w2v"), 7) as w:
        w.write_rows(words, rng.randn(len(words), 7).astype(np.float32))
    return str(tmp_path / "w2v")


@pytest.mark.parametrize("style", ["", "bow"])
def test_vocabulary_and_word2vec_match(w2v_dir, style):
    words = ["<unk>", "w0", "w5", "missing", "é", "w11", "absent"]
    vocabs = []
    for mod in (jax_vocab, port_vocab):
        v = mod.Vocabulary(style)
        for w in words + ["w0"]:
            v.add_word(w)
        vocabs.append(v)
    theirs, ours = vocabs
    assert (ours.word2idx, ours.idx2word, len(ours)) == \
        (theirs.word2idx, theirs.idx2word, len(theirs))
    if style == "bow":
        for v in vocabs:
            with pytest.raises(KeyError):
                v("nowhere")
    else:
        assert ours("nowhere") == theirs("nowhere") == 0
    for seed in (0, 5):
        want = jax_vocab.get_we_parameter(theirs, w2v_dir, seed=seed)
        got = port_vocab.get_we_parameter(ours, w2v_dir, seed=seed)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
