"""Retrieval metrics (port of dldkd_tpu/metrics.py).

The rank of the ground truth needs no sort: it is 1 + the number of videos
scoring strictly higher + the number of equal scores at a lower corpus
index, which is what a stable descending sort gives. `rank_of_gt` computes
that on the score matrix's own device; only the (Nq,) ranks go to the host.
The metric arithmetic is numpy, copied from the JAX package (reference
eval.py:59-111, 223-234): R@1/5/10/100, SumR, MedR, MeanR and mAP (single
ground truth: AP = 1/rank).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def rank_of_gt(scores: torch.Tensor, gt_idx: torch.Tensor) -> torch.Tensor:
    """1-based ranks (Nq,) int32 of gt_idx (Nq,) in scores (Nq, Nv)."""
    gt_idx = gt_idx.to(device=scores.device, dtype=torch.long)
    gt_score = torch.gather(scores, 1, gt_idx[:, None])           # (Nq, 1)
    higher = (scores > gt_score).sum(dim=1)
    col = torch.arange(scores.shape[1], device=scores.device)[None, :]
    tie_before = ((scores == gt_score) & (col < gt_idx[:, None])).sum(dim=1)
    return (higher + tie_before + 1).to(torch.int32)


def metrics_from_ranks(ranks: np.ndarray,
                       ks: Sequence[int] = (1, 5, 10, 100)
                       ) -> Dict[str, float]:
    ranks = np.asarray(ranks)
    n = len(ranks)
    out: Dict[str, float] = {}
    for k in ks:
        out[f"r{k}"] = 100.0 * float((ranks <= k).sum()) / n
    out["sumr"] = float(sum(out[f"r{k}"] for k in ks))
    out["medr"] = float(np.median(ranks))
    out["meanr"] = float(ranks.mean())
    out["map"] = float(np.mean(1.0 / ranks))
    return out


def build_gt_indices(query_video_ids: Sequence[str],
                     corpus_video_ids: Sequence[str]) -> np.ndarray:
    """Each query's corpus row (its video id is the '#'-prefix of the
    caption id)."""
    row = {v: i for i, v in enumerate(corpus_video_ids)}
    return np.asarray([row[v] for v in query_video_ids], np.int32)
