"""Corpus-sharded retrieval evaluation (port of
dldkd_tpu/parallel/eval_shard.py).

The corpus axis is split over the mesh (`mesh.shard_rows`: the corpus
padded to a multiple of the mesh size, one contiguous row range per
shard); the queries are encoded once, on the mesh's first device, and
copied to every shard device. Each shard's videos go through the video
tower kernels on its device (`fast_eval.encode_*_best`, or
`encode_context_q8` and `build_q8_index` with score_quant), and every
query is scored against the shard by the scorer kernels. The shards'
score columns are concatenated in shard order on the mesh's first device;
with a process group each process first all-gathers the others' columns,
so every process holds the whole (Nq, Nv) matrices and the same metrics.
Padded videos carry zero masks (the int8 index: the mask bias), so they
never outrank a real one, and their columns are cut before the ranks.

Two engines, as in the JAX package:
- resident (`eval_retrieval_sharded`): each shard goes through the
  single-device resident engine (`evaluate.embed_corpus(_q8)` in context
  batches, then `score_all_queries(_q8)` per query batch, on the queries
  encoded once);
- streaming (`eval_retrieval_sharded_streaming`): the corpus block is
  rounded up to a multiple of the mesh size, and each shard streams its
  rows in blocks of block / size through `evaluate._blocks_on_device`
  (the shards' streams interleaved), each block encoded and scored
  against every query at once.

Column layout: shard s's columns are the padded corpus rows it holds, so
column v is video v on every route. (The JAX package's per-shard int8
index pads each shard to its own 128-video grid and maps the ground truth
with `_q8_shard_gt`; the port cuts each shard's columns to its rows, so
no map is needed.) A single-branch model scores its corpus once per query
batch.
"""

from __future__ import annotations

import itertools
from typing import Dict, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from dldkd_tpu_torch.data.ingest import PackedQueries, PackedVideos
from dldkd_tpu_torch.evaluate import (Pair, _blocks_on_device,
                                      _gt_on_device,
                                      _metrics_from_score_matrices,
                                      embed_corpus, embed_corpus_q8,
                                      encode_all_queries, score_all_queries,
                                      score_all_queries_q8,
                                      score_encoded_block, score_q8_block)
from dldkd_tpu_torch.ops.fast_eval import (encode_context_best,
                                           encode_context_q8, tower_weights)
from dldkd_tpu_torch.parallel.mesh import Mesh, shard_rows


def _per_device(model, queries: PackedQueries, query_bsz: int, mesh: Mesh):
    """{device: (tower weights, (inher_q, explore_q) on it)} for every
    distinct shard device: the queries encoded once on the first device
    and copied."""
    dev0 = mesh.devices[0]
    weights = {d: tower_weights(model, d) for d in dict.fromkeys(mesh.devices)}
    q_i, q_e = encode_all_queries(model, queries, query_bsz, dev0,
                                  weights[dev0])
    return {d: (w, (q_i.to(d), None if q_e is None else q_e.to(d)))
            for d, w in weights.items()}


def _gather_columns(parts, mesh: Mesh) -> torch.Tensor:
    """This process's shards' (Nq, per) columns concatenated in shard
    order on the mesh's first device; with a process group, every
    process's blocks all-gathered (equal sizes) and concatenated in rank
    order after them."""
    local = torch.cat([p.to(mesh.devices[0]) for p in parts], dim=1)
    if mesh.n_processes == 1:
        return local
    blocks = [torch.empty_like(local) for _ in range(mesh.n_processes)]
    dist.all_gather(blocks, local.contiguous(), group=mesh.group)
    return torch.cat(blocks, dim=1)


def _resident_shard(model, videos: PackedVideos, rows: slice, dev,
                    weights, queries: Pair, query_bsz: int, context_bsz: int,
                    score_quant: bool) -> Pair:
    """One shard's (Nq, per) score columns per branch: the single-device
    resident engine on the shard's rows (`embed_corpus(_q8)` in context
    batches, then `score_all_queries(_q8)` on the encoded queries).
    Columns past the corpus end hold anything (cut by the caller)."""
    per, hi = rows.stop - rows.start, min(rows.stop, len(videos))
    if hi <= rows.start:   # a shard of padding alone
        blank = torch.zeros((queries[0].shape[0], per), device=dev)
        return blank, (blank if queries[1] is not None else None)
    shard = PackedVideos(videos.feats[rows.start:hi],
                         videos.mask[rows.start:hi], videos.ids[rows.start:hi])
    embed, score = ((embed_corpus_q8, score_all_queries_q8) if score_quant
                    else (embed_corpus, score_all_queries))
    scores = score(model, None, *embed(model, shard, context_bsz, dev,
                                       weights),
                   query_bsz, weights, encoded=queries)
    # the index pads to the context batch: cut or widen to the shard's rows
    return tuple(None if s is None else
                 F.pad(s, (0, per - s.shape[1])) if s.shape[1] < per
                 else s[:, :per] for s in scores)


def _streaming_shards(model, videos: PackedVideos, mesh: Mesh, block: int,
                      per_dev, score_quant: bool) -> list:
    """Each local shard's (Nq, per) score columns per branch, its rows
    streamed in blocks of `block` through `_blocks_on_device`; the
    shards' streams advance together so each device works while the host
    stages the next shard's block. Columns past the corpus end stay
    unwritten (cut by the caller)."""
    n = len(videos)
    rows = shard_rows(n, mesh)
    shards, streams = [], []
    for s, dev in mesh.local_shards():
        weights, (q_i, q_e) = per_dev[dev]
        per = rows[s].stop - rows[s].start
        out = [torch.empty((q_i.shape[0], per), dtype=torch.float32,
                           device=dev)
               for q in (q_i, q_e) if q is not None]
        shards.append((dev, weights, q_i, q_e, out))
        lo, hi = rows[s].start, min(rows[s].stop, n)
        streams.append(_blocks_on_device(   # a shard of padding: no block
            (videos.feats[lo:hi], videos.mask[lo:hi]), block, dev))
    try:
        for blocks in itertools.zip_longest(*streams):
            for (dev, weights, q_i, q_e, out), item in zip(shards, blocks):
                if item is None:
                    continue
                start, (feats, mask) = item
                if score_quant:
                    ctx = encode_context_q8(model, feats, mask, weights)
                    s_i, s_e = score_q8_block(q_i, q_e, *ctx, mask)
                else:
                    ctx = encode_context_best(model, feats, mask, weights)
                    s_i, s_e = score_encoded_block(q_i, q_e, *ctx, mask)
                cols = slice(start, start + s_i.shape[1])
                out[0][:, cols] = s_i
                if s_e is not None:
                    out[1][:, cols] = s_e
    finally:
        for stream in streams:   # stops each stream's staging worker
            stream.close()
    return [(out[0], out[1] if len(out) > 1 else None)
            for *_, out in shards]


@torch.no_grad()
def sharded_score_matrices(model, videos: PackedVideos,
                           queries: PackedQueries, mesh: Mesh,
                           query_bsz: int = 512, score_quant: bool = False,
                           corpus_block: int = 0, context_bsz: int = 200
                           ) -> Pair:
    """Both branches' (Nq, Nv) f32 score matrices on the mesh's first
    device (explore None for a single-branch model): the resident engine
    (each shard encoded in batches of context_bsz videos), or with
    corpus_block > 0 the streaming one."""
    per_dev = _per_device(model, queries, query_bsz, mesh)
    if corpus_block:
        parts = _streaming_shards(model, videos, mesh,
                                  -(-corpus_block // mesh.size), per_dev,
                                  score_quant)
    else:
        rows = shard_rows(len(videos), mesh)
        parts = [_resident_shard(model, videos, rows[s], dev,
                                 *per_dev[dev], query_bsz, context_bsz,
                                 score_quant)
                 for s, dev in mesh.local_shards()]
    n = len(videos)
    inher = _gather_columns([p[0] for p in parts], mesh)[:, :n]
    if parts[0][1] is None:
        return inher, None
    return inher, _gather_columns([p[1] for p in parts], mesh)[:, :n]


def _metrics(videos, queries, mesh, scores, fusion):
    return _metrics_from_score_matrices(
        *scores, _gt_on_device(queries, videos, mesh.devices[0]), fusion)


def eval_retrieval_sharded(
    model, videos: PackedVideos, queries: PackedQueries, mesh: Mesh,
    query_bsz: int = 512, fusion: Tuple[float, float] = (0.7, 0.3),
    score_quant: bool = False, context_bsz: int = 200,
) -> Dict[str, Dict[str, float]]:
    """Sharded counterpart of `evaluate.eval_retrieval` (resident): the
    same metric dicts, every shard encoded on its device in batches of
    context_bsz videos; with score_quant each shard builds its own
    prebuilt int8 index."""
    return _metrics(videos, queries, mesh, sharded_score_matrices(
        model, videos, queries, mesh, query_bsz, score_quant,
        context_bsz=context_bsz), fusion)


def eval_retrieval_sharded_streaming(
    model, videos: PackedVideos, queries: PackedQueries, mesh: Mesh,
    corpus_block: int = 2048, query_bsz: int = 512,
    fusion: Tuple[float, float] = (0.7, 0.3), score_quant: bool = False,
) -> Dict[str, Dict[str, float]]:
    """Streaming and sharding composed: each shard streams its rows in
    blocks of corpus_block / mesh size (rounded up), so device memory holds
    one block per shard; the metrics of `eval_retrieval_sharded`."""
    return _metrics(videos, queries, mesh, sharded_score_matrices(
        model, videos, queries, mesh, query_bsz, score_quant,
        corpus_block=corpus_block), fusion)
