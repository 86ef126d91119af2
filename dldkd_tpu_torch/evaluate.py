"""Corpus-scale retrieval evaluation (port of dldkd_tpu/evaluate.py).

Reference flow (eval.py:114-263): encode the whole video corpus, encode the
queries in batches, score every query against every video (masked cosine,
max over frames), rank the ground truth, and report R@K/SumR/mAP per branch
and for the 0.7/0.3 fusion.

This is the corpus-resident engine. The encoded corpus, the (Nq, Nv) score
matrices and the ranks stay on the device; chunks are written in place into
one preallocated buffer; only the (Nq,) ranks go to the host. Padded videos
carry zero masks, so they score -1e10 and never win. The streaming engine,
the corpus-sharded (mesh) engine and int8 scoring are not ported yet
(ROADMAP A11, A12, A14): asking for them raises NotImplementedError.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dldkd_tpu_torch import resolve_device
from dldkd_tpu_torch.data.ingest import PackedQueries, PackedVideos
from dldkd_tpu_torch.metrics import (build_gt_indices, metrics_from_ranks,
                                     rank_of_gt)
from dldkd_tpu_torch.ops.fast_eval import (encode_context_best,
                                           encode_query_best, tower_dtype,
                                           tower_weights)
from dldkd_tpu_torch.ops.masking import l2_normalize
from dldkd_tpu_torch.ops.similarity import clip_scores_maxpool

Pair = Tuple[torch.Tensor, Optional[torch.Tensor]]


def _chunk(x: np.ndarray, start: int, n: int, device) -> torch.Tensor:
    """Rows [start, start + n) of x on `device`, zero-padded to n rows."""
    block = torch.from_numpy(np.ascontiguousarray(x[start:start + n]))
    if block.shape[0] < n:
        block = torch.cat([block, block.new_zeros(
            (n - block.shape[0],) + tuple(block.shape[1:]))])
    return block.to(device)


@torch.no_grad()
def embed_corpus(model, videos: PackedVideos, context_bsz: int = 200,
                 device=None, weights: Optional[dict] = None,
                 plain: bool = False
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                            torch.Tensor]:
    """Encode every corpus video: (Np, L, H) inheritance, (Np, L, H)
    exploration (or None) and the (Np, L) mask, on `device`, where Np is the
    video count rounded up to the context batch. Padded videos carry zero
    masks."""
    dev = resolve_device(device)
    weights = weights or tower_weights(model, dev)
    n = len(videos)
    n_pad = -(-n // context_bsz) * context_bsz
    mask = _chunk(videos.mask, 0, n_pad, dev)
    inher = explore = None
    for start in range(0, n, context_bsz):
        feats = _chunk(videos.feats, start, context_bsz, dev)
        ich, ech = encode_context_best(model, feats,
                                       mask[start:start + context_bsz],
                                       weights, plain)
        if inher is None:
            inher = ich.new_zeros((n_pad,) + tuple(ich.shape[1:]))
            if ech is not None:
                explore = ech.new_zeros((n_pad,) + tuple(ech.shape[1:]))
        inher[start:start + context_bsz] = ich
        if ech is not None:
            explore[start:start + context_bsz] = ech
    return inher, explore, mask


@torch.no_grad()
def score_all_queries(model, queries: PackedQueries, ctx_inher: torch.Tensor,
                      ctx_explore: Optional[torch.Tensor],
                      ctx_mask: torch.Tensor, query_bsz: int = 50,
                      weights: Optional[dict] = None, plain: bool = False
                      ) -> Pair:
    """(Nq, Nv) f32 score matrices for both branches, on the corpus'
    device. The frames are L2-normalized once here, not once per query
    batch (the same values: the normalization is per frame)."""
    dev = ctx_inher.device
    weights = weights or tower_weights(model, dev)
    n = len(queries)
    n_pad = -(-n // query_bsz) * query_bsz
    nv = ctx_inher.shape[0]
    cn_i = l2_normalize(ctx_inher)
    cn_e = l2_normalize(ctx_explore) if ctx_explore is not None else None
    inher = torch.empty((n_pad, nv), dtype=torch.float32, device=dev)
    explore = (torch.empty((n_pad, nv), dtype=torch.float32, device=dev)
               if cn_e is not None else None)
    for start in range(0, n, query_bsz):
        feats = _chunk(queries.feats, start, query_bsz, dev)
        mask = _chunk(queries.mask, start, query_bsz, dev)
        q_i, q_e = encode_query_best(model, feats, mask, weights, plain)
        rows = slice(start, start + query_bsz)
        inher[rows] = clip_scores_maxpool(q_i, cn_i, ctx_mask,
                                          ctx_normalized=True, plain=plain)
        if cn_e is not None:
            explore[rows] = clip_scores_maxpool(q_e, cn_e, ctx_mask,
                                                ctx_normalized=True,
                                                plain=plain)
    return inher[:n], (explore[:n] if explore is not None else None)


def score_matrices(model, videos: PackedVideos, queries: PackedQueries,
                   context_bsz: int = 200, query_bsz: int = 50, device=None,
                   plain: bool = False) -> Pair:
    """Both branches' (Nq, Np) score matrices on `device`. plain=True runs
    every kernel's plain PyTorch version instead, on any device: the
    reference side of a kernel check."""
    dev = resolve_device(device)
    weights = tower_weights(model, dev)
    ctx_i, ctx_e, ctx_mask = embed_corpus(model, videos, context_bsz, dev,
                                          weights, plain)
    return score_all_queries(model, queries, ctx_i, ctx_e, ctx_mask,
                             query_bsz, weights, plain)


def _metrics_from_score_matrices(inher_s: torch.Tensor,
                                 explore_s: Optional[torch.Tensor],
                                 gt: torch.Tensor,
                                 fusion: Tuple[float, float]
                                 ) -> Dict[str, Dict[str, float]]:
    """Ranks on the device, metric dicts on the host. A single-branch
    model reports its 'inher' metrics under 'fused' as well."""
    def metrics(scores):
        return metrics_from_ranks(rank_of_gt(scores, gt).cpu().numpy())

    out = {"inher": metrics(inher_s)}
    if explore_s is not None:
        out["explore"] = metrics(explore_s)
        out["fused"] = metrics(fusion[0] * inher_s + fusion[1] * explore_s)
    else:
        out["fused"] = dict(out["inher"])
    return out


def resident_eval_bytes(n_videos: int, n_queries: int, mcfg) -> int:
    """Peak device-memory estimate of the resident engine: the encoded
    frames of every branch (x2 for the normalized copy), the three (Nq, Nv)
    f32 score matrices, and fixed slack for input chunks."""
    itemsize = torch.tensor([], dtype=tower_dtype(mcfg)).element_size()
    hiddens = [mcfg.inheritance_hidden] + (
        [mcfg.exploration_hidden] if mcfg.double_branch else [])
    ctx = sum(n_videos * mcfg.max_ctx_l * h * itemsize for h in hiddens)
    return 2 * ctx + 3 * n_queries * n_videos * 4 + 256 * 1024 * 1024


def _check_resident_fits(n_videos: int, n_queries: int, mcfg,
                         dev: torch.device) -> None:
    """The JAX engine streams the corpus when the resident footprint
    exceeds free device memory; the port has no streaming engine yet, so
    it refuses instead of running out of memory."""
    if dev.type != "cuda":
        return
    free, _ = torch.cuda.mem_get_info(dev)
    need = resident_eval_bytes(n_videos, n_queries, mcfg)
    if need > free:
        raise NotImplementedError(
            f"the resident eval needs ~{need} bytes, {free} are free on "
            f"{dev}; the corpus-streaming engine is ROADMAP A12, not ported")


@torch.no_grad()
def eval_retrieval(model, videos: PackedVideos, queries: PackedQueries,
                   context_bsz: int = 200, query_bsz: int = 50,
                   fusion: Tuple[float, float] = (0.7, 0.3),
                   score_quant: bool = False,
                   corpus_stream_bsz: Optional[int] = None,
                   device=None) -> Dict[str, Dict[str, float]]:
    """Full eval epoch (reference eval_epoch, eval.py:237-263):
    {'inher', 'explore', 'fused'} metric dicts, 'fused' from
    0.7 * inheritance + 0.3 * exploration. corpus_stream_bsz: None checks
    that the resident engine fits the device, 0 takes it unchecked, > 0
    (streaming) is not ported."""
    dev = resolve_device(device)
    if score_quant:
        raise NotImplementedError(
            "int8 scoring (score_quant) is ROADMAP A11, not ported")
    if corpus_stream_bsz:
        raise NotImplementedError(
            "streaming eval (corpus_stream_bsz > 0) is ROADMAP A12, "
            "not ported")
    if corpus_stream_bsz is None:
        _check_resident_fits(len(videos), len(queries), model.config, dev)
    inher_s, explore_s = score_matrices(model, videos, queries, context_bsz,
                                        query_bsz, dev)
    gt = torch.from_numpy(build_gt_indices(queries.video_ids,
                                           videos.ids)).to(dev)
    return _metrics_from_score_matrices(inher_s, explore_s, gt, fusion)


def run_retrieval_eval(model, videos: PackedVideos, queries: PackedQueries,
                       eval_cfg, mesh=None, device=None
                       ) -> Dict[str, Dict[str, float]]:
    """The drivers' entry point: routes by the config's corpus_stream_bsz
    (0 = auto, -1 = resident, > 0 = stream) and the mesh, as
    dldkd_tpu.evaluate.run_retrieval_eval does. Only the resident engine on
    one device is ported."""
    if mesh is not None:
        raise NotImplementedError(
            "corpus-sharded (multi-GPU) eval is ROADMAP A14, not ported")
    stream = eval_cfg.corpus_stream_bsz
    return eval_retrieval(model, videos, queries,
                          context_bsz=eval_cfg.eval_context_bsz,
                          query_bsz=eval_cfg.eval_query_bsz,
                          score_quant=eval_cfg.score_quant,
                          corpus_stream_bsz=(None if stream == 0 else
                                             0 if stream < 0 else stream),
                          device=device)
