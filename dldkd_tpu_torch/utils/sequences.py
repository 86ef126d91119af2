"""Sequence padding and span-search helpers, host-side numpy (the port's
own copy of dldkd_tpu/utils/sequences.py; reference
utils/tensor_utils.py:5-142, unused by the DL-DKD training path).

`pad_sequences_*` pad variable-length arrays into one array plus a float
mask (1 = valid); `find_max_triples*` give the best (start, end, score)
spans, vectorized over the reference's per-row loops.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def pad_sequences_1d(
    sequences: Sequence,
    dtype=np.float32,
    fixed_length: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a list of n-d arrays (or a single-nested list) whose FIRST dim
    varies into one (n+1)-d array plus a (N, L) float mask (1 = valid).
    Reference tensor_utils.py:5-55.

    fixed_length pads every row to that length (all rows must fit).
    """
    seqs = [np.asarray(s, dtype=dtype) for s in sequences]
    extra_dims = seqs[0].shape[1:]
    lengths = [len(s) for s in seqs]
    max_length = fixed_length if fixed_length is not None else max(lengths)
    if fixed_length is not None and max(lengths) > fixed_length:
        raise ValueError(
            f"a sequence of length {max(lengths)} exceeds fixed_length "
            f"{fixed_length}")
    padded = np.zeros((len(seqs), max_length) + extra_dims, dtype=dtype)
    mask = np.zeros((len(seqs), max_length), np.float32)
    for i, (seq, n) in enumerate(zip(seqs, lengths)):
        padded[i, :n] = seq
        mask[i, :n] = 1.0
    return padded, mask


def pad_sequences_2d(sequences: Sequence, dtype=np.float32
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a double-nested list (rows of variable-count, variable-length
    inner sequences) into a (B, P, L, ...) array + (B, P, L) mask.
    Reference tensor_utils.py:58-97.
    """
    bsz = len(sequences)
    rows = [[np.asarray(inner, dtype=dtype) for inner in seq]
            for seq in sequences]
    max_para = max(len(r) for r in rows)
    max_sen = max(max(len(inner) for inner in r) for r in rows)
    extra_dims = rows[0][0].shape[1:]
    padded = np.zeros((bsz, max_para, max_sen) + extra_dims, dtype=dtype)
    mask = np.zeros((bsz, max_para, max_sen), np.float32)
    for b, r in enumerate(rows):
        for p, inner in enumerate(r):
            padded[b, p, : len(inner)] = inner
            mask[b, p, : len(inner)] = 1.0
    return padded, mask


def top_n_array_2d(array_2d: np.ndarray, top_n: int) -> np.ndarray:
    """Top-n (row, col, value) triples of a 2-d array, value-descending.
    Reference tensor_utils.py:131-142."""
    flat_order = np.argsort(array_2d, axis=None)[::-1][:top_n]
    rows, cols = np.unravel_index(flat_order, array_2d.shape)
    vals = array_2d[rows, cols]
    return np.stack([rows, cols, vals], axis=1)


def find_max_triples_from_upper_triangle_product(
    upper_product: np.ndarray, top_n: int = 5,
    prob_thd: Optional[float] = None,
) -> List[np.ndarray]:
    """Per batch row: top-n (start, end, confidence) from an (N, L, L)
    upper-triangular score product. Reference tensor_utils.py:115-129
    (including its quirk of thresholding on the row index slot — fixed
    here to threshold on the confidence column)."""
    out = []
    for mat in upper_product:
        triples = top_n_array_2d(mat, top_n=top_n)
        if prob_thd is not None:
            triples = triples[triples[:, 2] >= prob_thd]
        out.append(triples)
    return out


def find_max_triples(st_prob: np.ndarray, ed_prob: np.ndarray,
                     top_n: int = 5, prob_thd: Optional[float] = None
                     ) -> List[np.ndarray]:
    """Batched best (start < end) span pairs by st_prob[k1] * ed_prob[k2].
    Reference tensor_utils.py:100-113."""
    st_prob = np.asarray(st_prob, np.float32)
    ed_prob = np.asarray(ed_prob, np.float32)
    product = np.einsum("bm,bn->bmn", st_prob, ed_prob)
    upper = np.triu(product, k=1)
    return find_max_triples_from_upper_triangle_product(
        upper, top_n=top_n, prob_thd=prob_thd)
