"""Exact top-k search in plain PyTorch, and the comparison that decides a
search cell's `correct`.

`fused_scores` encodes the corpus and the given queries with
`reference.model` (through `eval_ref.reference_eval`) and fuses both
branches' masked-cosine scores 0.7 / 0.3, as the eval's reference fuses
them. `top_k` is the stable descending sort's first k: equal scores go
to the lower corpus index. `compare_search` holds the top k that the
program returned for some queries against those fused scores:

  scores_abs_err   each returned score against the reference's fused
                   score at the returned id: max |difference|
  ids_out_of_band  returned ids whose reference score lies below the
                   reference's k-th best by more than tau, plus ids not
                   returned whose reference score lies above it by more
                   than tau; tau is twice the scores' limit (a near-tie
                   may flip, nothing else may)
  order_breaks     rows whose list is not a top k in order: an id
                   outside the corpus or twice in the row, a score above
                   the one before it, or an equal score at a lower index
                   after a higher one; an answer that is not one list of
                   k for each query (too few or too many rows or
                   entries) counts every row
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from benchmark.reference import eval_ref


@torch.no_grad()
def fused_scores(P, cfg: dict, data: dict, rows: Sequence[int], device,
                 exact: bool = True) -> torch.Tensor:
    """(len(rows), n_videos) fused scores of the pool's `rows` against
    every video of `data` (host arrays: vfeats, vmask, qfeats, qmask).
    exact=False computes the float32 products in TF32: the control."""
    rows = np.asarray(rows, np.int64)
    part = {"vfeats": data["vfeats"], "vmask": data["vmask"],
            "qfeats": data["qfeats"][rows], "qmask": data["qmask"][rows],
            "gt": np.zeros(len(rows), np.int64)}
    out = eval_ref.reference_eval(P, cfg, part, device,
                                  cfg["eval_context_bsz"], exact=exact)
    scores = out["scores"]
    if "fused" in scores:
        return scores["fused"]
    return scores["inheritance"]


def top_k(scores: torch.Tensor, k: int):
    """(values, ids) of the k best per row; ties to the lower index."""
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


@torch.no_grad()
def compare_search(scores: np.ndarray, ids: np.ndarray,
                   reference: torch.Tensor, k: int, scores_limit: float
                   ) -> Dict[str, float]:
    """The numbers of the module doc for returned (scores, ids), due as
    (Nq, k) each, against the reference's (Nq, Nv) fused scores. A
    misshapen answer is judged on the rows and entries it has."""
    dev = reference.device
    nq, nv = reference.shape
    scores, ids = np.atleast_2d(scores), np.atleast_2d(ids)
    shaped = scores.shape == ids.shape == (nq, k)
    rows = min(nq, scores.shape[0], ids.shape[0])
    cols = min(k, scores.shape[1], ids.shape[1])
    reference = reference[:rows]
    s = torch.from_numpy(np.ascontiguousarray(scores[:rows, :cols],
                                              np.float32)).to(dev)
    i = torch.from_numpy(np.ascontiguousarray(ids[:rows, :cols],
                                              np.int64)).to(dev)
    inside = ((i >= 0) & (i < nv)).all(dim=1)
    ic = i.clamp(0, nv - 1)
    srt = torch.sort(ic, dim=1).values
    twice = (srt[:, 1:] == srt[:, :-1]).any(dim=1)
    rises = (s[:, 1:] > s[:, :-1]).any(dim=1)
    tie_up = ((s[:, 1:] == s[:, :-1]) & (i[:, 1:] < i[:, :-1])).any(dim=1)
    order_breaks = nq if not shaped else int(
        (~inside | twice | rises | tie_up).sum())
    at = torch.gather(reference, 1, ic)
    err = float((s - at).abs().max()) if s.numel() else 0.0
    tau = 2.0 * scores_limit
    kth = top_k(reference, k)[0][:, -1:]
    returned = torch.zeros_like(reference, dtype=torch.bool)
    returned.scatter_(1, ic, True)
    low_in = (at < kth - tau).sum()
    high_out = ((reference > kth + tau) & ~returned).sum()
    return {"scores_abs_err": err,
            "ids_out_of_band": float(low_in + high_out),
            "order_breaks": float(order_breaks)}
