"""Corpus-scale retrieval evaluation (port of dldkd_tpu/evaluate.py).

Reference flow (eval.py:114-263): encode the whole video corpus, encode the
queries in batches, score every query against every video (masked cosine,
max over frames), rank the ground truth, and report R@K/SumR/mAP per branch
and for the 0.7/0.3 fusion.

This is the corpus-resident engine. The encoded corpus, the (Nq, Nv) score
matrices and the ranks stay on the device; chunks are written in place into
one preallocated buffer; only the (Nq,) ranks go to the host. Padded videos
carry zero masks, so they score -1e10 and never win. With score_quant the
towers emit an int8 index directly (`embed_corpus_q8`) and the queries are
scored against it by the int8 kernel (`score_all_queries_q8`). The
streaming engine and the corpus-sharded (mesh) engine are not ported yet
(ROADMAP A12, A14): asking for them raises NotImplementedError.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dldkd_tpu_torch import resolve_device
from dldkd_tpu_torch.data.ingest import PackedQueries, PackedVideos
from dldkd_tpu_torch.metrics import (build_gt_indices, metrics_from_ranks,
                                     rank_of_gt)
from dldkd_tpu_torch.ops.fast_eval import (encode_context_best,
                                           encode_context_q8,
                                           encode_query_best, tower_dtype,
                                           tower_weights)
from dldkd_tpu_torch.ops.kernels.sim_max import build_q8_index
from dldkd_tpu_torch.ops.masking import l2_normalize
from dldkd_tpu_torch.ops.similarity import (clip_scores_maxpool,
                                            clip_scores_maxpool_pre8)

Pair = Tuple[torch.Tensor, Optional[torch.Tensor]]


def _chunk(x: np.ndarray, start: int, n: int, device) -> torch.Tensor:
    """Rows [start, start + n) of x on `device`, zero-padded to n rows."""
    block = torch.from_numpy(np.ascontiguousarray(x[start:start + n]))
    if block.shape[0] < n:
        block = torch.cat([block, block.new_zeros(
            (n - block.shape[0],) + tuple(block.shape[1:]))])
    return block.to(device)


def _embed(encode, model, videos: PackedVideos, context_bsz: int, device,
           weights: Optional[dict], plain: bool):
    """Run `encode` over the corpus in context batches into preallocated
    (Np, L, H) buffers per branch; returns (inher, explore or None,
    (Np, L) mask)."""
    dev = resolve_device(device)
    weights = weights or tower_weights(model, dev)
    n = len(videos)
    n_pad = -(-n // context_bsz) * context_bsz
    mask = _chunk(videos.mask, 0, n_pad, dev)
    inher = explore = None
    for start in range(0, n, context_bsz):
        feats = _chunk(videos.feats, start, context_bsz, dev)
        ich, ech = encode(model, feats, mask[start:start + context_bsz],
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
def embed_corpus(model, videos: PackedVideos, context_bsz: int = 200,
                 device=None, weights: Optional[dict] = None,
                 plain: bool = False
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                            torch.Tensor]:
    """Encode every corpus video: (Np, L, H) inheritance, (Np, L, H)
    exploration (or None) and the (Np, L) mask, on `device`, where Np is the
    video count rounded up to the context batch. Padded videos carry zero
    masks."""
    return _embed(encode_context_best, model, videos, context_bsz, device,
                  weights, plain)


@torch.no_grad()
def embed_corpus_q8(model, videos: PackedVideos, context_bsz: int = 200,
                    device=None, weights: Optional[dict] = None,
                    plain: bool = False
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                               torch.Tensor]:
    """The prebuilt int8 scoring index of the whole corpus: (rows
    inheritance (Np, L, H) int8, rows exploration or None, bias (Np, L)
    int32), in `ops.kernels.sim_max.build_q8_index` layout. The towers emit
    int8 (the emit_q8 epilogue), so frames in the tower dtype never exist
    beyond one launch; the index is half the size of bf16 frames. Padded
    videos carry the mask bias."""
    inher, explore, mask = _embed(encode_context_q8, model, videos,
                                  context_bsz, device, weights, plain)
    rows_i, bias = build_q8_index(inher, mask)
    rows_e = build_q8_index(explore, mask)[0] if explore is not None \
        else None
    return rows_i, rows_e, bias


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


@torch.no_grad()
def score_all_queries_q8(model, queries: PackedQueries, q8_i: torch.Tensor,
                         q8_e: Optional[torch.Tensor], bias: torch.Tensor,
                         query_bsz: int = 50, weights: Optional[dict] = None,
                         plain: bool = False) -> Pair:
    """(Nq, Np) f32 score matrices against the prebuilt int8 index. Valid
    videos score bitwise as clip_scores_maxpool(quantized=True) on the same
    quantized components; padded ones sit at the dequantized mask bias
    (~-6.7e4), below any real score."""
    dev = q8_i.device
    weights = weights or tower_weights(model, dev)
    n = len(queries)
    n_pad = -(-n // query_bsz) * query_bsz
    nv = q8_i.shape[0]
    inher = torch.empty((n_pad, nv), dtype=torch.float32, device=dev)
    explore = (torch.empty((n_pad, nv), dtype=torch.float32, device=dev)
               if q8_e is not None else None)
    for start in range(0, n, query_bsz):
        feats = _chunk(queries.feats, start, query_bsz, dev)
        mask = _chunk(queries.mask, start, query_bsz, dev)
        q_i, q_e = encode_query_best(model, feats, mask, weights, plain)
        rows = slice(start, start + query_bsz)
        inher[rows] = clip_scores_maxpool_pre8(q_i, q8_i, bias, plain)
        if q8_e is not None:
            explore[rows] = clip_scores_maxpool_pre8(q_e, q8_e, bias, plain)
    return inher[:n], (explore[:n] if explore is not None else None)


def score_matrices(model, videos: PackedVideos, queries: PackedQueries,
                   context_bsz: int = 200, query_bsz: int = 50, device=None,
                   plain: bool = False, score_quant: bool = False) -> Pair:
    """Both branches' (Nq, Np) score matrices on `device`, from the int8
    index with score_quant. plain=True runs every kernel's plain PyTorch
    version instead, on any device: the reference side of a kernel
    check."""
    dev = resolve_device(device)
    weights = tower_weights(model, dev)
    if score_quant:
        q8_i, q8_e, bias = embed_corpus_q8(model, videos, context_bsz, dev,
                                           weights, plain)
        return score_all_queries_q8(model, queries, q8_i, q8_e, bias,
                                    query_bsz, weights, plain)
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


def device_memory_budget(device) -> Optional[int]:
    """Free bytes on a CUDA device (torch.cuda.mem_get_info), None on the
    CPU; $DLDKD_EVAL_MEM_BUDGET overrides either."""
    env = os.environ.get("DLDKD_EVAL_MEM_BUDGET")
    if env:
        try:
            return int(env)
        except ValueError:
            pass
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(dev)[0])


def resident_eval_bytes(n_videos: int, n_queries: int, mcfg,
                        score_quant: bool = False) -> int:
    """Peak device-memory estimate of the resident engine: the encoded
    frames of every branch (x2 for the normalized copy or the build), the
    three (Nq, Nv) f32 score matrices, and fixed slack for input chunks.
    With score_quant the resident index is int8 (itemsize 1)."""
    itemsize = 1 if score_quant else torch.tensor(
        [], dtype=tower_dtype(mcfg)).element_size()
    hiddens = [mcfg.inheritance_hidden] + (
        [mcfg.exploration_hidden] if mcfg.double_branch else [])
    ctx = sum(n_videos * mcfg.max_ctx_l * h * itemsize for h in hiddens)
    return 2 * ctx + 3 * n_queries * n_videos * 4 + 256 * 1024 * 1024


def _check_resident_fits(n_videos: int, n_queries: int, mcfg,
                         dev: torch.device, score_quant: bool) -> None:
    """The JAX engine streams the corpus when the resident footprint
    exceeds free device memory; the port has no streaming engine yet, so
    it refuses instead of running out of memory."""
    free = device_memory_budget(dev)
    if free is None:
        return
    need = resident_eval_bytes(n_videos, n_queries, mcfg, score_quant)
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
    0.7 * inheritance + 0.3 * exploration. score_quant: the int8 engine
    (the towers emit the int8 index, int8 scoring). corpus_stream_bsz: None
    checks that the resident engine fits the device, 0 takes it
    unchecked, > 0 (streaming) is not ported."""
    dev = resolve_device(device)
    if corpus_stream_bsz:
        raise NotImplementedError(
            "streaming eval (corpus_stream_bsz > 0) is ROADMAP A12, "
            "not ported")
    if corpus_stream_bsz is None:
        _check_resident_fits(len(videos), len(queries), model.config, dev,
                             score_quant)
    inher_s, explore_s = score_matrices(model, videos, queries, context_bsz,
                                        query_bsz, dev,
                                        score_quant=score_quant)
    gt = torch.from_numpy(build_gt_indices(queries.video_ids,
                                           videos.ids)).to(dev)
    return _metrics_from_score_matrices(inher_s, explore_s, gt, fusion)


def run_retrieval_eval(model, videos: PackedVideos, queries: PackedQueries,
                       eval_cfg, mesh=None, device=None
                       ) -> Dict[str, Dict[str, float]]:
    """The drivers' entry point: routes by the config's corpus_stream_bsz
    (0 = auto, -1 = resident, > 0 = stream) and the mesh, as
    dldkd_tpu.evaluate.run_retrieval_eval does. Only the resident engine on
    one device is ported. A module in training mode (the per-epoch
    validation) is evaluated in eval mode and handed back in training
    mode."""
    if mesh is not None:
        raise NotImplementedError(
            "corpus-sharded (multi-GPU) eval is ROADMAP A14, not ported")
    stream = eval_cfg.corpus_stream_bsz
    was_training = model.training
    model.eval()
    try:
        return eval_retrieval(model, videos, queries,
                              context_bsz=eval_cfg.eval_context_bsz,
                              query_bsz=eval_cfg.eval_query_bsz,
                              score_quant=eval_cfg.score_quant,
                              corpus_stream_bsz=(None if stream == 0 else
                                                 0 if stream < 0 else stream),
                              device=device)
    finally:
        model.train(was_training)
