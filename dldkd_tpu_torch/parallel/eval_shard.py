"""Corpus-sharded retrieval evaluation (port of
dldkd_tpu/parallel/eval_shard.py).

The corpus axis is split over the mesh (`mesh.shard_rows`: the corpus
padded to a multiple of the mesh size, one contiguous row range per
shard); the queries are encoded once, on the mesh's first device, and
copied to every shard device. Each shard's videos go through the video
tower kernels on its device (`evaluate._encode_block`: frames, or with
score_quant the int8 index), and every
query is scored against the shard by the scorer kernels. The shards'
score columns are concatenated in shard order on the mesh's first device;
with a process group each process first all-gathers the others' columns,
so every process holds the whole (Nq, Nv) matrices and the same metrics.
Padded videos carry zero masks (the int8 index: the mask bias), so they
never outrank a real one, and their columns are cut before the ranks.

Two engines, as in the JAX package, both reached through
`evaluate.run_retrieval_eval`, which ranks the gathered columns:
- resident (`sharded_score_matrices(corpus_block=0)`): each shard goes
  through the single-device resident engine (`evaluate.embed_corpus` in
  context batches, then `score_all_queries` on the queries encoded once);
- streaming (`corpus_block > 0`): the corpus block is rounded up to a
  multiple of the mesh size, and each shard streams its rows in blocks of
  block / size through the single-device streaming block loop
  (`evaluate._stream_columns`, the shards' streams advancing together),
  each block encoded and scored against every query at once.

Column layout: shard s's columns are the padded corpus rows it holds, so
column v is video v on every route. (The JAX package's per-shard int8
index pads each shard to its own 128-video grid and maps the ground truth
with `_q8_shard_gt`; the port cuts each shard's columns to its rows, so
no map is needed.) A single-branch model scores its corpus once per query
batch.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from dldkd_tpu_torch.data.ingest import PackedQueries, PackedVideos
from dldkd_tpu_torch.evaluate import (Pair, _stream_columns, embed_corpus,
                                      encode_all_queries, score_all_queries)
from dldkd_tpu_torch.ops.fast_eval import tower_weights
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
    resident engine on the shard's rows (`embed_corpus` in context
    batches, then `score_all_queries` on the encoded queries). Columns
    past the corpus end hold anything (cut by the caller)."""
    per, hi = rows.stop - rows.start, min(rows.stop, len(videos))
    if hi <= rows.start:   # a shard of padding alone
        blank = torch.zeros((queries[0].shape[0], per), device=dev)
        return blank, (blank if queries[1] is not None else None)
    shard = PackedVideos(videos.feats[rows.start:hi],
                         videos.mask[rows.start:hi], videos.ids[rows.start:hi])
    index = embed_corpus(model, shard, context_bsz, dev, weights,
                         score_quant=score_quant)
    scores = score_all_queries(model, None, *index, query_bsz, weights,
                               encoded=queries)
    # the index pads to the context batch: cut or widen to the shard's rows
    return tuple(None if s is None else
                 F.pad(s, (0, per - s.shape[1])) if s.shape[1] < per
                 else s[:, :per] for s in scores)


@torch.no_grad()
def sharded_score_matrices(model, videos: PackedVideos,
                           queries: PackedQueries, mesh: Mesh,
                           query_bsz: int = 512, score_quant: bool = False,
                           corpus_block: int = 0, context_bsz: int = 200
                           ) -> Pair:
    """Both branches' (Nq, Nv) f32 score matrices on the mesh's first
    device (explore None for a single-branch model): the resident engine
    (each shard encoded in batches of context_bsz videos; with score_quant
    each shard builds its own prebuilt int8 index), or with corpus_block >
    0 the streaming one, each shard streaming its rows in blocks of
    corpus_block / mesh size (rounded up), so device memory holds one block
    per shard."""
    per_dev = _per_device(model, queries, query_bsz, mesh)
    rows = shard_rows(len(videos), mesh)
    if corpus_block:
        parts = _stream_columns(
            model, videos, [(dev, *per_dev[dev], rows[s])
                            for s, dev in mesh.local_shards()],
            -(-corpus_block // mesh.size), score_quant)
    else:
        parts = [_resident_shard(model, videos, rows[s], dev,
                                 *per_dev[dev], query_bsz, context_bsz,
                                 score_quant)
                 for s, dev in mesh.local_shards()]
    n = len(videos)
    inher = _gather_columns([p[0] for p in parts], mesh)[:, :n]
    if parts[0][1] is None:
        return inher, None
    return inher, _gather_columns([p[1] for p in parts], mesh)[:, :n]
