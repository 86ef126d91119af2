"""The retrieval eval in plain PyTorch, and the comparison that decides an
eval cell's `correct`.

`reference_eval` encodes the corpus and the queries with
`reference.model`, scores every query against every video (masked
cosine, max over frames), and ranks each query's ground truth, in blocks
so that it fits beside the program's outputs. `compare_eval` holds the
program's outputs of one eval call against it:

  frames_rel_err    the encoded frames of both branches, valid frames of
                    every video: max |program - reference| / max |reference|
  queries_rel_err   the pooled query vectors of both branches, the same
  scores_abs_err    the two (Nq, Nv) score matrices: max |difference|
  ranks_out_of_band queries whose ground-truth rank (each branch and the
                    0.7 / 0.3 fusion) lies outside what the reference's
                    scores allow at twice the scores' limit: a near-tie
                    may flip, nothing else may
  metrics_gap       the call's returned metric dicts against the metric
                    arithmetic below applied to the call's own ranks

Ranks follow a stable descending sort: 1 + the videos scoring higher +
the equal ones at a lower corpus index.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from benchmark.reference import model as ref

FUSION = (0.7, 0.3)


def rank_of_gt(scores: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    gt = gt.long()
    g = torch.gather(scores, 1, gt[:, None])
    higher = (scores > g).sum(dim=1)
    col = torch.arange(scores.shape[1], device=scores.device)[None, :]
    ties = ((scores == g) & (col < gt[:, None])).sum(dim=1)
    return higher + ties + 1


def rank_band(scores: torch.Tensor, gt: torch.Tensor, tau: float):
    """The lowest and highest rank any scores within tau of `scores`
    (entrywise) can give the ground truth: (lo, hi) per query."""
    gt = gt.long()
    g = torch.gather(scores, 1, gt[:, None])
    lo = (scores > g + 2 * tau).sum(dim=1) + 1
    col = torch.arange(scores.shape[1], device=scores.device)[None, :]
    hi = ((scores >= g - 2 * tau) & (col != gt[:, None])).sum(dim=1) + 1
    return lo, hi


def metrics_from_ranks(ranks: np.ndarray, ks: Sequence[int] = (1, 5, 10, 100)
                       ) -> Dict[str, float]:
    """R@K, SumR, MedR, MeanR and mAP (one ground truth: AP = 1 / rank),
    the reference's eval.py:59-111."""
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


@torch.no_grad()
def reference_eval(P: ref.Params, cfg: dict, inputs: dict, device,
                   context_bsz: int = 200, query_bsz: int = 1024,
                   exact: bool = True) -> dict:
    """Frames, pooled queries, score matrices and ranks of every branch
    (and the fusion's ranks) from the host inputs (`inputs`: vfeats,
    vmask, qfeats, qmask numpy, gt numpy int). exact=False computes the
    float32 products in TF32: the control."""
    P = {k: v.to(device) for k, v in P.items()}
    nv, nq = inputs["vfeats"].shape[0], inputs["qfeats"].shape[0]
    vmask = torch.from_numpy(inputs["vmask"]).to(device)
    gt = torch.from_numpy(inputs["gt"]).to(device)
    out = {"frames": {}, "queries": {}, "scores": {}, "ranks": {}}
    with ref.exact_f32(exact):
        for br in ref.branches(cfg):
            frames = None
            for s in range(0, nv, context_bsz):
                x = torch.from_numpy(inputs["vfeats"][s:s + context_bsz]).to(
                    device)
                y = ref.encode_context(P, cfg, br, x, vmask[s:s + context_bsz])
                if frames is None:
                    frames = y.new_empty((nv,) + tuple(y.shape[1:]))
                frames[s:s + y.shape[0]] = y
            pooled = None
            for s in range(0, nq, query_bsz):
                x = torch.from_numpy(inputs["qfeats"][s:s + query_bsz]).to(
                    device)
                m = torch.from_numpy(inputs["qmask"][s:s + query_bsz]).to(
                    device)
                y = ref.encode_query(P, cfg, br, x, m)
                if pooled is None:
                    pooled = y.new_empty((nq, y.shape[1]))
                pooled[s:s + y.shape[0]] = y
            out["frames"][br] = frames
            out["queries"][br] = pooled
            out["scores"][br] = ref.clip_scores_max(pooled, frames, vmask)
    names = ref.branches(cfg)
    if len(names) == 2:
        out["scores"]["fused"] = (FUSION[0] * out["scores"][names[0]]
                                  + FUSION[1] * out["scores"][names[1]])
    for key, s in out["scores"].items():
        out["ranks"][key] = rank_of_gt(s, gt)
    return out


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    scale = float(b.abs().max())
    return float((a - b).abs().max()) / max(scale, 1e-30)


@torch.no_grad()
def compare_eval(prog: dict, reference: dict, gt: np.ndarray,
                 vmask: np.ndarray, scores_limit: float) -> Dict[str, float]:
    """The numbers of the module doc. `prog` holds the program's call:
    frames / queries / scores / ranks per key (tensors, the program's
    padding rows and columns included), and `metrics` (its returned
    dicts). The reference's keys are "inheritance", "exploration",
    "fused"; the program's "inher", "explore", "fused"."""
    keys = {"inheritance": "inher", "exploration": "explore",
            "fused": "fused"}
    dev = reference["scores"]["inheritance"].device
    valid = torch.from_numpy(vmask).to(dev) > 0
    nv, nq = valid.shape[0], gt.shape[0]
    gt_t = torch.from_numpy(gt).to(dev)
    frames = queries = scores = 0.0
    out_of_band = 0
    for rkey, s_ref in reference["scores"].items():
        pkey = keys[rkey]
        if rkey in reference["frames"]:
            f_p = prog["frames"][pkey][:nv].to(dev)
            f_r = reference["frames"][rkey]
            frames = max(frames, _rel(f_p[valid], f_r[valid]))
            queries = max(queries, _rel(prog["queries"][pkey][:nq].to(dev),
                                        reference["queries"][rkey]))
            scores = max(scores, float((prog["scores"][pkey][:nq, :nv].to(
                dev) - s_ref).abs().max()))
        tau = scores_limit * (1.0 if rkey != "fused" else
                              FUSION[0] + FUSION[1])
        lo, hi = rank_band(s_ref, gt_t, tau)
        r = prog["ranks"][pkey].to(dev).long()[:nq]
        out_of_band += int(((r < lo) | (r > hi)).sum())
    gap = 0.0
    for pkey, m in prog["metrics"].items():
        mine = metrics_from_ranks(prog["ranks"][pkey].cpu().numpy())
        gap = max(gap, max(abs(m[k] - mine[k]) for k in mine))
    return {"frames_rel_err": frames, "queries_rel_err": queries,
            "scores_abs_err": scores, "ranks_out_of_band": float(out_of_band),
            "metrics_gap": gap}
