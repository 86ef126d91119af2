"""Vocabulary + pretrained word-embedding loader (the port's copy of
dldkd_tpu/data/vocab.py).

The reference's `Vocabulary` / `get_we_parameter`: unused by the DL-DKD
path (the models consume precomputed RoBERTa/CLIP features), kept for API
completeness. `get_we_parameter` reads word2vec vectors from a BigFile
store, with a seeded uniform fallback for out-of-vocabulary words.
"""

from __future__ import annotations

import numpy as np

from dldkd_tpu_torch.data.bigfile import BigFile


class Vocabulary:
    """Word <-> index map. Bag-of-words styles ('bow' in text_style)
    KeyError on unknown words; every other style falls back to '<unk>'."""

    def __init__(self, text_style: str = ""):
        self.word2idx = {}
        self.idx2word = {}
        self.idx = 0
        self.text_style = text_style

    def add_word(self, word: str) -> None:
        if word not in self.word2idx:
            self.word2idx[word] = self.idx
            self.idx2word[self.idx] = word
            self.idx += 1

    def __call__(self, word: str) -> int:
        if word not in self.word2idx and "bow" not in self.text_style:
            return self.word2idx["<unk>"]
        return self.word2idx[word]

    def __len__(self) -> int:
        return len(self.word2idx)


def get_we_parameter(vocab: Vocabulary, w2v_file: str,
                     seed: int = 0) -> np.ndarray:
    """(len(vocab), ndims) embedding-init matrix from a word2vec BigFile;
    missing words get uniform(-1, 1) rows drawn in vocabulary order from
    `seed`."""
    reader = BigFile(w2v_file)
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(len(vocab)):
        try:
            rows.append(reader.read([vocab.idx2word[i]])[0])
        except (KeyError, ValueError, OSError):
            rows.append(rng.uniform(-1, 1, reader.ndims).astype(np.float32))
    return np.stack(rows)
