"""Self-contained CLIP BPE tokenizer (the port's copy of
dldkd_tpu/tools/clip_tokenizer.py, same API and the same ids).

Vocabulary layout (the data contract with the merge file
assets/bpe_simple_vocab_16e6.txt.gz, a byte-for-byte copy of the JAX
package's): 256 byte units, the same 256 suffixed with the end-of-word
marker '</w>', one entry per merge rule in file order, then
'<|startoftext|>' (49406) and '<|endoftext|>' (49407) — 49408 ids total.

Text cleaning: ftfy.fix_text when ftfy is importable (a no-op for
well-formed text), html-unescaping twice, whitespace runs to one space.

The original splits words with the `regex` module's
  <|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d
  |[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+      (IGNORECASE)
This module imports no `regex`: `_words` scans the text with
`unicodedata` and gives the same splits, with these classes:
- whitespace is `regex`'s `\\s`: `str.isspace()` less U+001C-U+001F,
  which `regex` does not count as space;
- case-insensitive, the specials and contractions also match upper-case
  ASCII and U+017F (long s, which folds to 's');
- U+0345 (combining ypogegrammeni, which folds to a Greek letter) is in
  none of the case-insensitive classes, so the scan skips it as it skips
  whitespace;
- letters and numbers are `unicodedata`'s categories L* and N*. Python's
  `unicodedata` (15.0 on Python 3.12) leaves unassigned the code points
  that later Unicode versions made letters (9,568) or numbers (93) and
  that a newer `regex` classes so; here they fall in the run of other
  symbols (ROADMAP C9).
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
import unicodedata
from typing import Dict, List, Sequence, Tuple

import numpy as np

VOCAB_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "assets", "bpe_simple_vocab_16e6.txt.gz")
SOT = "<|startoftext|>"
EOT = "<|endoftext|>"
_N_MERGES = 49152 - 256 - 2  # merge rows consumed from the vocab file

# the pattern's literal alternatives, in its order
_SPECIALS = (SOT, EOT)
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
# simple case folding onto the literals' characters (all ASCII)
_FOLD = str.maketrans("ABCDEFGHIJKLMNOPQRSTUVWXYZ\u017f",
                      "abcdefghijklmnopqrstuvwxyzs")
_NOT_SPACE = frozenset("\x1c\x1d\x1e\x1f")
_SKIPPED = frozenset("\u0345")
# a run of `regex`'s whitespace: `re`'s (str.isspace) less U+001C-U+001F
_SPACE_RUN = re.compile(r"[^\S\x1c-\x1f]+")


def _is_space(c: str) -> bool:
    return c.isspace() and c not in _NOT_SPACE


@functools.lru_cache(maxsize=1 << 16)
def _kind(c: str) -> str:
    """'S' (space, or skipped), 'L' (letter), 'N' (number) or 'O'."""
    if _is_space(c) or c in _SKIPPED:
        return "S"
    cat = unicodedata.category(c)[0]
    return cat if cat in "LN" else "O"


def _literal_at(text: str, i: int, literals) -> str:
    """The first of `literals` at text[i:], case-insensitive, or ''."""
    for lit in literals:
        if text[i:i + len(lit)].translate(_FOLD) == lit:
            return text[i:i + len(lit)]
    return ""


def _words(text: str) -> List[str]:
    """The pattern's findall: at each position the first alternative that
    matches (specials, contractions, a letter run, one number, a run of
    other symbols); whitespace between words is dropped."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        lit = ""
        if c == "<":
            lit = _literal_at(text, i, _SPECIALS)
        elif c == "'":
            lit = _literal_at(text, i, _CONTRACTIONS)
        if lit:
            out.append(lit)
            i += len(lit)
            continue
        kind = _kind(c)
        if kind == "S":
            i += 1
            continue
        j = i + 1
        if kind != "N":
            while j < n and _kind(text[j]) == kind:
                j += 1
        out.append(text[i:j])
        i = j
    return out


@functools.lru_cache()
def byte_unicode_table() -> Dict[int, str]:
    """Reversible byte -> printable-unicode map: printable latin bytes map
    to themselves; the rest are relocated above U+0100 so no BPE symbol is
    whitespace or a control character."""
    printable = (list(range(ord("!"), ord("~") + 1))
                 + list(range(ord("\xa1"), ord("\xac") + 1))
                 + list(range(ord("\xae"), ord("\xff") + 1)))
    table = {b: chr(b) for b in printable}
    hole = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + hole)
            hole += 1
    return table


def _clean(text: str) -> str:
    """ftfy (when importable), html-unescape twice, collapse whitespace."""
    try:
        import ftfy
        text = ftfy.fix_text(text)
    except ImportError:
        pass
    text = html.unescape(html.unescape(text))
    return _SPACE_RUN.sub(" ", text).strip()


class ClipTokenizer:
    """Byte-level BPE with end-of-word markers, CLIP vocabulary."""

    def __init__(self, vocab_path: str = VOCAB_PATH):
        self._byte_enc = byte_unicode_table()
        self._byte_dec = {c: b for b, c in self._byte_enc.items()}
        with gzip.open(vocab_path, "rt", encoding="utf-8") as f:
            rows = f.read().split("\n")[1:_N_MERGES + 1]
        merges: List[Tuple[str, str]] = [tuple(r.split()) for r in rows]
        self._rank = {pair: i for i, pair in enumerate(merges)}
        units = list(self._byte_enc.values())
        tokens = (units + [u + "</w>" for u in units]
                  + ["".join(p) for p in merges] + [SOT, EOT])
        self.encoder: Dict[str, int] = {t: i for i, t in enumerate(tokens)}
        self.decoder: Dict[int, str] = {i: t for t, i in self.encoder.items()}
        self.sot_id = self.encoder[SOT]
        self.eot_id = self.encoder[EOT]
        self._bpe_cache: Dict[str, List[str]] = {SOT: [SOT], EOT: [EOT]}

    # ------------------------------------------------------------- BPE core

    def _best_pair(self, word: List[str]):
        """Lowest-rank adjacent pair, or None when no pair is mergeable."""
        best, best_rank = None, len(self._rank)
        for pair in zip(word, word[1:]):
            r = self._rank.get(pair, -1)
            if 0 <= r < best_rank:
                best, best_rank = pair, r
        return best

    @staticmethod
    def _merge(word: List[str], first: str, second: str) -> List[str]:
        """Merge all non-overlapping (first, second) occurrences, left to
        right."""
        out, i = [], 0
        while i < len(word):
            if (i + 1 < len(word) and word[i] == first
                    and word[i + 1] == second):
                out.append(first + second)
                i += 2
            else:
                out.append(word[i])
                i += 1
        return out

    def _bpe(self, token: str) -> List[str]:
        """Split one pre-tokenized word (unicode-mapped bytes) into BPE
        symbols; the final byte carries the '</w>' marker."""
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        word = list(token[:-1]) + [token[-1] + "</w>"] if token else []
        while len(word) > 1:
            pair = self._best_pair(word)
            if pair is None:
                break
            word = self._merge(word, *pair)
        self._bpe_cache[token] = word
        return word

    # ------------------------------------------------------------- public

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in _words(_clean(text).lower()):
            mapped = "".join(self._byte_enc[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[sym] for sym in self._bpe(mapped))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        raw = bytes(self._byte_dec[c] for c in text
                    if c in self._byte_dec)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def tokenize(self, texts: Sequence[str], context_length: int = 77
                 ) -> Dict[str, np.ndarray]:
        """Batch to fixed-length model inputs: <sot> ids <eot>, truncated
        to context_length (eot always kept), padded with eot. Returns
        {input_ids, attention_mask}, int32. CLIP's text pooling reads the
        argmax-id position, which stays the FIRST eot under eot-padding."""
        n = len(texts)
        input_ids = np.full((n, context_length), self.eot_id, np.int32)
        mask = np.zeros((n, context_length), np.int32)
        for r, text in enumerate(texts):
            ids = [self.sot_id] + self.encode(text)
            ids = ids[:context_length - 1] + [self.eot_id]
            input_ids[r, :len(ids)] = ids
            mask[r, :len(ids)] = 1
        return {"input_ids": input_ids, "attention_mask": mask}
