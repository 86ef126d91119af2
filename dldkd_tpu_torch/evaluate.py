"""Corpus-scale retrieval evaluation (port of dldkd_tpu/evaluate.py).

Reference flow (eval.py:114-263): encode the whole video corpus, encode the
queries in batches, score every query against every video (masked cosine,
max over frames), rank the ground truth, and report R@K/SumR/mAP per branch
and for the 0.7/0.3 fusion.

One entry, `run_retrieval_eval`: it takes the route once (`eval_plan`: the
engine, the corpus block and the query block, from the config, the
device's free memory and the mesh), runs that engine's score matrices,
then the metric tail (`_gt_on_device`, `_metrics_from_score_matrices`).
The engines, each callable with explicit block sizes:

- resident (`score_matrices`): the encoded corpus (`embed_corpus`), the
  (Nq, Nv) score matrices and the ranks stay on the device; chunks are
  written in place into one preallocated buffer; only the (Nq,) ranks go
  to the host. The context batches, padded to their full size, and the
  query blocks, the last trimmed, reach the card through
  `_blocks_on_device`; each query block is one query-tower launch and one
  scorer launch per branch against the whole corpus
  (`score_all_queries`). Padded videos carry zero masks, so they score
  -1e10 and never win;
- streaming (`stream_score_matrices`): the packed corpus stays in host
  memory; the queries are encoded once, then each corpus block goes through
  the video towers and is scored against every query in one launch per
  branch, so device memory holds one block, not the corpus. The block loop
  (`_stream_columns`) also serves every shard of the sharded streaming
  engine;
- on a mesh (`parallel/`), the corpus-sharded engines
  (`parallel/eval_shard.sharded_score_matrices`), which run the two above
  per shard.

The index format is behind one seam: `_encode_block` gives a batch's float
frames and mask, or with score_quant its int8 index and int32 bias (the
towers emit int8 directly), and the scorers (`block_scorers`, which
`score_all_queries` and the streaming block loop call) pick the float or
the int8 kernel from what they are handed.

Every input batch of every engine reaches the device through one staging
path, `_blocks_on_device`: on the card a worker thread fills two pinned
slots ahead of the card and each slot is copied on a side stream.

Under a torch profiler the layers are spans (`utils/tracing.py`):
eval/run (`run_retrieval_eval`, every route), eval/corpus (the corpus
encode: `embed_corpus`, or the single-device streaming block loop),
eval/score (`score_all_queries`), eval/rank
(`_metrics_from_score_matrices`), and eval/h2d around each hand-over to
the device (`_blocks_on_device` on the main thread: waiting for a filled
slot and queuing its copy; the ground truth's copy), which counts the bytes
it hands over as eval.h2d_bytes, and those that went through a pinned slot
as eval.h2d_pinned_bytes as well; eval/h2d_order around the side stream's
wait for the compute stream before a staging's first copy; eval/stage
around each fill of a slot on the worker thread."""

from __future__ import annotations

import itertools
import os
import queue as queue_mod
import threading
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
from dldkd_tpu_torch.utils.tracing import count, span, traced

Pair = Tuple[torch.Tensor, Optional[torch.Tensor]]


def _gt_on_device(queries: PackedQueries, videos: PackedVideos, dev
                  ) -> torch.Tensor:
    """Each query's corpus row (int32), on `dev`."""
    gt = torch.from_numpy(build_gt_indices(queries.video_ids, videos.ids))
    with span("eval/h2d"):
        count("eval.h2d_bytes", gt.nbytes)
        return gt.to(dev)


# Two slots: the worker's fill sets the corpus's pace (on an H100's host
# 12-20 GB/s into pinned memory with torch's intra-op threads, against 45
# GB/s for the copy and ~2.4 ms of towers a 105 MB context batch), so a
# slot's copy has ended before the worker comes back to it. A slot holds
# as many whole blocks as fit in _SLOT_BYTES, at least one: a fill of a few
# MB costs the worker about as much in thread hand-offs as in copying
# (50-query batches of 6.3 MB five to a slot: an eval call at ActivityNet's
# size 0.71 -> 0.63 s on an H100; 64 MB no better). A resident query block
# (RESIDENT_QUERY_BSZ: 63 MB at d_q 1,024, 47 MB at 768) fills one alone.
_SLOTS = 2
_SLOT_BYTES = 32 << 20

# The resident engine's query block, the floor run_retrieval_eval puts
# under eval_query_bsz: one query-tower launch and one scorer launch per
# branch for each block, against the whole resident corpus.
RESIDENT_QUERY_BSZ = 512


def _blocks_on_device(arrays, block: int, device, pad: bool = False):
    """Yield (start, [rows of each array on `device`]) for the consecutive
    row blocks [start, start + block) of the numpy `arrays` (one row
    count): the last block trimmed to its rows, or with `pad` zero-padded
    to `block` rows (the resident engine's context batches).

    On the CPU each block is the arrays' rows as host tensors (a padded
    block a new tensor). On a CUDA device the blocks go in groups through
    two pinned host slots, each with its device buffer, and are staged
    ahead of the card: a worker thread fills the slots (`Tensor.copy_`,
    torch's intra-op threads; padded rows zeroed, since a slot holds the
    rows of the group two back) while the caller queues its work on the
    blocks before, and the main thread copies each filled slot
    `non_blocking` on a side stream. The side stream first waits for the
    work already queued on the compute stream, which may still use the
    memory the device buffers were given; then events order the copy
    before the compute stream reads the group (`copied`), the copy after
    the kernels that read the slot's device buffer two groups back
    (`consumed`, waited for on the side stream), and the worker's refill
    of a pinned slot after its last copy. A yielded block's tensors are
    valid until the next one is asked for. Closing the generator early
    stops and joins the worker."""
    n = arrays[0].shape[0]
    starts = range(0, n, block)
    if device.type != "cuda":
        for start in starts:
            with span("eval/h2d"):
                staged = [torch.from_numpy(np.ascontiguousarray(
                    a[start:start + block])) for a in arrays]
                if pad and staged[0].shape[0] < block:
                    staged = [torch.cat([t, t.new_zeros(
                        (block - t.shape[0],) + tuple(t.shape[1:]))])
                        for t in staged]
                count("eval.h2d_bytes", sum(t.nbytes for t in staged))
            yield start, staged
        return
    if not starts:
        return
    per_slot = max(1, _SLOT_BYTES // (block * sum(a[:1].nbytes
                                                  for a in arrays)))
    groups = [starts[g:g + per_slot] for g in range(0, len(starts), per_slot)]
    k = min(_SLOTS, len(groups))
    width = per_slot * block if pad else min(per_slot * block, n)
    pinned = [[torch.empty((width,) + a.shape[1:],
                           dtype=torch.from_numpy(a[:0]).dtype,
                           pin_memory=True) for a in arrays]
              for _ in range(k)]
    on_card = [[torch.empty(p.shape, dtype=p.dtype, device=device)
                for p in slot] for slot in pinned]
    compute = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    # The device buffers come from the caching allocator on the compute
    # stream, which hands out memory that kernels queued there may still
    # read or write (the previous phase's tower buffers, freed once their
    # launches were queued); no copy into them starts before that work.
    with span("eval/h2d_order"):
        side.wait_stream(compute)
    copied = [torch.cuda.Event() for _ in range(k)]
    consumed = [torch.cuda.Event() for _ in range(k)]
    # main -> worker: one token per queued copy (None: stop); worker ->
    # main: each filled group in order, or the worker's exception
    handed, filled = queue_mod.Queue(), queue_mod.Queue()
    stop = threading.Event()

    def fill() -> None:
        try:
            with torch.cuda.device(device):
                for j, group in enumerate(groups):
                    s, lo = j % k, group[0]
                    rows = min(len(group) * block, n - lo)
                    if j >= k:
                        if handed.get() is None:
                            return
                        copied[s].synchronize()   # group j - k's copy
                    if stop.is_set():
                        return
                    with span("eval/stage"):
                        for a, p in zip(arrays, pinned[s]):
                            p[:rows].copy_(torch.from_numpy(
                                np.ascontiguousarray(a[lo:lo + rows])))
                            if pad:
                                p[rows:len(group) * block].zero_()
                    filled.put(j)
        except BaseException as e:  # surfaced on the consumer's side
            filled.put(e)

    worker = threading.Thread(target=fill, name="eval-stage", daemon=True)
    worker.start()
    try:
        for j, group in enumerate(groups):
            s, lo = j % k, group[0]
            m = len(group) * block if pad else min(len(group) * block,
                                                   n - lo)
            with span("eval/h2d"):
                got = filled.get()
                if isinstance(got, BaseException):
                    raise got
                with torch.cuda.stream(side):
                    if j >= k:
                        side.wait_event(consumed[s])
                    for p, d in zip(pinned[s], on_card[s]):
                        d[:m].copy_(p[:m], non_blocking=True)
                    copied[s].record(side)
                handed.put(True)
                compute.wait_event(copied[s])
                nbytes = sum(p[:m].nbytes for p in pinned[s])
                count("eval.h2d_bytes", nbytes)
                count("eval.h2d_pinned_bytes", nbytes)
            for start in group:
                yield start, [d[start - lo:min(start - lo + block, m)]
                              for d in on_card[s]]
            # the caller has queued the group's work on the compute stream
            consumed[s].record(compute)
    finally:
        stop.set()
        handed.put(None)
        worker.join()


def _encode_block(model, feats: torch.Tensor, mask: torch.Tensor,
                  weights: dict, plain: bool, score_quant: bool):
    """One batch of videos through the video towers, in the index format
    the scorers take: (frames inheritance, frames exploration or None,
    the (Nv, L) mask), or with score_quant the batch's int8 index (rows
    inheritance, rows exploration or None, (Nv, L) int32 bias, in
    `ops.kernels.sim_max.build_q8_index` layout), the towers emitting int8
    directly (the emit_q8 epilogue) so frames in the tower dtype never
    exist beyond one launch."""
    if not score_quant:
        return (*encode_context_best(model, feats, mask, weights, plain),
                mask)
    q8_i, q8_e = encode_context_q8(model, feats, mask, weights, plain)
    rows_i, bias = build_q8_index(q8_i, mask)
    return rows_i, (None if q8_e is None else q8_e.contiguous()), bias


@torch.no_grad()
@traced("eval/corpus")
def embed_corpus(model, videos: PackedVideos, context_bsz: int = 200,
                 device=None, weights: Optional[dict] = None,
                 plain: bool = False, score_quant: bool = False
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                            torch.Tensor]:
    """Encode every corpus video in context batches into preallocated
    buffers on `device`, Np rows each, Np the video count rounded up to
    the context batch: (Np, L, H) inheritance frames, exploration frames
    (or None) and the (Np, L) mask; padded videos carry zero masks. With
    score_quant the prebuilt int8 index instead (`_encode_block`), half
    the size of bf16 frames: int8 rows per branch and the int32 bias,
    padded videos at the mask bias."""
    dev = resolve_device(device)
    weights = weights or tower_weights(model, dev)
    n_pad = -(-len(videos) // context_bsz) * context_bsz
    inher = explore = aux = None
    for start, (feats, batch_mask) in _blocks_on_device(
            (videos.feats, videos.mask), context_bsz, dev, pad=True):
        ich, ech, batch_aux = _encode_block(model, feats, batch_mask,
                                            weights, plain, score_quant)
        if inher is None:
            aux = batch_aux.new_empty((n_pad,) + tuple(batch_aux.shape[1:]))
            inher = ich.new_zeros((n_pad,) + tuple(ich.shape[1:]))
            if ech is not None:
                explore = ech.new_zeros((n_pad,) + tuple(ech.shape[1:]))
        rows = slice(start, start + context_bsz)
        aux[rows] = batch_aux
        inher[rows] = ich
        if ech is not None:
            explore[rows] = ech
    return inher, explore, aux


def _query_batches(model, queries: Optional[PackedQueries], query_bsz: int,
                   dev, weights: dict, plain: bool,
                   encoded: Optional[Pair]):
    """(start, inheritance block, exploration block or None) over the
    queries, in blocks of query_bsz (the last trimmed): each block staged
    and encoded by one `encode_query_best` call, or sliced from `encoded`,
    the pooled query vectors already on `dev`."""
    if encoded is not None:
        q_i, q_e = encoded
        for start in range(0, q_i.shape[0], query_bsz):
            b = slice(start, start + query_bsz)
            yield start, q_i[b], (q_e[b] if q_e is not None else None)
        return
    for start, (feats, mask) in _blocks_on_device(
            (queries.feats, queries.mask), query_bsz, dev):
        yield (start,) + tuple(encode_query_best(model, feats, mask, weights,
                                                 plain))


def block_scorers(ctx_i: torch.Tensor, ctx_e: Optional[torch.Tensor],
                  aux: torch.Tensor, plain: bool = False):
    """Each branch's scorer against encoded corpus rows, None for a branch
    the model lacks: a function from (Nq, D) queries to their (Nq, Nv) f32
    scores in one launch. The scorer is chosen by what it is handed. An
    int8 index and its int32 bias (`_encode_block`): the prebuilt-index
    int8 kernel (valid videos bitwise as clip_scores_maxpool(quantized=True)
    on the same quantized components; padded ones at the dequantized mask
    bias, ~-6.7e4, below any real score). Float frames and their mask:
    masked cosine, max over frames, the frames L2-normalized once here,
    not once per call (the same values: the normalization is per
    frame)."""
    def scorer(ctx):
        if ctx is None:
            return None
        if ctx.dtype == torch.int8:
            return lambda q: clip_scores_maxpool_pre8(q, ctx, aux, plain)
        cn = l2_normalize(ctx)
        return lambda q: clip_scores_maxpool(q, cn, aux, ctx_normalized=True,
                                             plain=plain)
    return scorer(ctx_i), scorer(ctx_e)


@torch.no_grad()
@traced("eval/score")
def score_all_queries(model, queries: Optional[PackedQueries],
                      ctx_inher: torch.Tensor,
                      ctx_explore: Optional[torch.Tensor],
                      ctx_aux: torch.Tensor, query_bsz: int = 50,
                      weights: Optional[dict] = None, plain: bool = False,
                      encoded: Optional[Pair] = None) -> Pair:
    """(Nq, Np) f32 score matrices for both branches against the encoded
    corpus `embed_corpus` returned (frames and mask, or the int8 index and
    its bias), on its device, through `block_scorers`. `encoded`: the
    queries' pooled vectors on the corpus' device
    (`encode_all_queries`), scored in blocks of query_bsz in place of
    `queries` (the sharded engine encodes them once for every shard). Each
    block's scores go into its rows of the preallocated matrices."""
    dev = ctx_inher.device
    weights = weights or tower_weights(model, dev)
    n = len(queries) if encoded is None else encoded[0].shape[0]
    nv = ctx_inher.shape[0]
    score_i, score_e = block_scorers(ctx_inher, ctx_explore, ctx_aux, plain)
    inher = torch.empty((n, nv), dtype=torch.float32, device=dev)
    explore = (torch.empty((n, nv), dtype=torch.float32, device=dev)
               if score_e is not None else None)
    for start, q_i, q_e in _query_batches(model, queries, query_bsz, dev,
                                          weights, plain, encoded):
        rows = slice(start, start + q_i.shape[0])
        inher[rows] = score_i(q_i)
        if score_e is not None:
            explore[rows] = score_e(q_e)
    return inher, explore


def score_matrices(model, videos: PackedVideos, queries: PackedQueries,
                   context_bsz: int = 200, query_bsz: int = 50, device=None,
                   plain: bool = False, score_quant: bool = False) -> Pair:
    """The resident engine: both branches' (Nq, Np) score matrices on
    `device`, from the int8 index with score_quant. plain=True runs every
    kernel's plain PyTorch version instead, on any device: the reference
    side of a kernel check."""
    dev = resolve_device(device)
    weights = tower_weights(model, dev)
    index = embed_corpus(model, videos, context_bsz, dev, weights, plain,
                         score_quant)
    return score_all_queries(model, queries, *index, query_bsz, weights,
                             plain)


@traced("eval/rank")
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


DEFAULT_STREAM_BLOCK = 2048


def auto_stream_block(n_videos: int, n_queries: int, mcfg,
                      n_devices: int = 1, budget: Optional[int] = None,
                      block: int = DEFAULT_STREAM_BLOCK,
                      score_quant: bool = False, device=None) -> int:
    """Engine policy: 0 when the resident engine fits the budget (or the
    device reports none), else the streaming corpus block. budget: free
    bytes, by default `device_memory_budget(device)` (device default
    "cuda"). With n_devices each holds 1/n_devices of the corpus."""
    if budget is None:
        budget = device_memory_budget("cuda" if device is None else device)
    if budget is None:
        return 0
    need = resident_eval_bytes(-(-n_videos // n_devices), n_queries, mcfg,
                               score_quant)
    return 0 if need <= budget else min(block, n_videos)


@torch.no_grad()
def encode_all_queries(model, queries: PackedQueries, query_bsz: int = 512,
                       device=None, weights: Optional[dict] = None,
                       plain: bool = False) -> Pair:
    """Pooled query vectors of every caption, (Nq, H) per branch, on
    `device`: a few MB even at full-dataset scale."""
    dev = resolve_device(device)
    weights = weights or tower_weights(model, dev)
    inher = explore = None
    for start, (feats, mask) in _blocks_on_device(
            (queries.feats, queries.mask), query_bsz, dev):
        q_i, q_e = encode_query_best(model, feats, mask, weights, plain)
        if inher is None:
            inher = q_i.new_empty((len(queries),) + tuple(q_i.shape[1:]))
            if q_e is not None:
                explore = q_e.new_empty(inher.shape)
        inher[start:start + q_i.shape[0]] = q_i
        if q_e is not None:
            explore[start:start + q_e.shape[0]] = q_e
    return inher, explore


def _stream_columns(model, videos: PackedVideos, shards, block: int,
                    score_quant: bool, plain: bool = False) -> list:
    """The streaming block loop, for one device or every local shard of a
    mesh. shards: (device, tower weights, (inher_q, explore_q) on it, the
    slice of corpus rows it scores) each. Each shard's rows are staged in
    blocks of `block` through `_blocks_on_device`, and each block goes
    through the video towers (`_encode_block`) and is scored against every
    query in one launch per branch (`block_scorers`), its columns written in
    place into the shard's preallocated (Nq, rows) f32 buffer per branch;
    returns those buffers, (inher, explore or None) per shard. The shards'
    streams advance together, so each device works while the host stages
    the next shard's block; every stream is closed on exit, which stops
    its staging worker. Columns past the corpus end stay unwritten."""
    n = len(videos)
    outs, streams = [], []
    for dev, _, (q_i, q_e), rows in shards:
        outs.append([None if q is None else torch.empty(
            (q_i.shape[0], rows.stop - rows.start), dtype=torch.float32,
            device=dev) for q in (q_i, q_e)])
        lo, hi = rows.start, min(rows.stop, n)
        streams.append(_blocks_on_device(   # a shard of padding: no block
            (videos.feats[lo:hi], videos.mask[lo:hi]), block, dev))
    try:
        for blocks in itertools.zip_longest(*streams):
            for (_, weights, (q_i, q_e), _), out, item in zip(shards, outs,
                                                              blocks):
                if item is None:
                    continue
                start, (feats, mask) = item
                score_i, score_e = block_scorers(*_encode_block(
                    model, feats, mask, weights, plain, score_quant),
                    plain=plain)
                cols = slice(start, start + feats.shape[0])
                out[0][:, cols] = score_i(q_i)
                if score_e is not None:
                    out[1][:, cols] = score_e(q_e)
                del score_i, score_e   # one encoded block alive at a time
    finally:
        for stream in streams:
            stream.close()
    return [tuple(out) for out in outs]


@torch.no_grad()
def stream_score_matrices(model, videos: PackedVideos,
                          queries: PackedQueries, corpus_block: int = 2048,
                          query_bsz: int = 512, device=None,
                          score_quant: bool = False, plain: bool = False
                          ) -> Pair:
    """The streaming engine: both branches' (Nq, Nv) score matrices with
    device memory bounded by one corpus block instead of the encoded
    corpus (dldkd_tpu/evaluate.py:450-512). The queries are encoded once,
    then each corpus block, copied from host memory, is encoded and scored
    against all of them (`_stream_columns`); the score columns persist:
    Nq x Nv x 4 bytes per branch. With score_quant the towers emit each
    block's int8 index. plain=True runs every kernel's plain version
    instead, as in score_matrices."""
    dev = resolve_device(device)
    weights = tower_weights(model, dev)
    encoded = encode_all_queries(model, queries, query_bsz, dev, weights,
                                 plain)
    with span("eval/corpus"):
        scores, = _stream_columns(
            model, videos, [(dev, weights, encoded, slice(0, len(videos)))],
            corpus_block, score_quant, plain)
    return scores


def eval_plan(n_videos: int, n_queries: int, mcfg, eval_cfg,
              mesh_size: int = 0, budget: Optional[int] = None
              ) -> Tuple[int, int]:
    """The eval's route, as dldkd_tpu.evaluate.run_retrieval_eval takes
    it: (corpus block, query block). The config's corpus_stream_bsz: 0 =
    auto (`auto_stream_block` against `budget`, free bytes per device, each
    of the mesh_size devices holding 1/mesh_size of the corpus; None: no
    budget, resident), -1 = resident, > 0 = stream with that block; a
    corpus block of 0 means the resident engine. mesh_size: 0 for one
    device without a mesh. The query block is eval_query_bsz, at least
    RESIDENT_QUERY_BSZ on the resident single-device route and at least 64
    on the others (streaming, and every mesh route)."""
    block = eval_cfg.corpus_stream_bsz
    if block == 0:
        block = 0 if budget is None else auto_stream_block(
            n_videos, n_queries, mcfg, max(mesh_size, 1), budget,
            score_quant=eval_cfg.score_quant)
    block = max(block, 0)
    floor = RESIDENT_QUERY_BSZ if not (mesh_size or block) else 64
    return block, max(eval_cfg.eval_query_bsz, floor)


@traced("eval/run")
@torch.no_grad()
def run_retrieval_eval(model, videos: PackedVideos, queries: PackedQueries,
                       eval_cfg, mesh=None, device=None
                       ) -> Dict[str, Dict[str, float]]:
    """The eval: {'inher', 'explore', 'fused'} metric dicts (reference
    eval_epoch, eval.py:237-263), 'fused' from 0.7 * inheritance + 0.3 *
    exploration. Takes the route `eval_plan` gives for the config, the
    device's free memory and the mesh (`parallel.Mesh`: the sharded
    engines, `parallel/eval_shard.py`), runs its engine (the resident one
    encodes the corpus, or each shard, in context batches of
    eval_context_bsz; score_quant: the int8 index and int8 scoring), then
    ranks the ground truth. `device` is ignored on a mesh: its devices
    hold the shards. A module in training mode (the per-epoch validation)
    is evaluated in eval mode and handed back in training mode."""
    dev = resolve_device(mesh.devices[0] if mesh is not None else device)
    corpus_block, query_bsz = eval_plan(
        len(videos), len(queries), model.config, eval_cfg,
        mesh.size if mesh is not None else 0, device_memory_budget(dev))
    quant = eval_cfg.score_quant
    was_training = model.training
    model.eval()
    try:
        if mesh is not None:
            from dldkd_tpu_torch.parallel import eval_shard

            scores = eval_shard.sharded_score_matrices(
                model, videos, queries, mesh, query_bsz, quant, corpus_block,
                eval_cfg.eval_context_bsz)
        elif corpus_block:
            scores = stream_score_matrices(model, videos, queries,
                                           corpus_block, query_bsz, dev,
                                           quant)
        else:
            scores = score_matrices(model, videos, queries,
                                    eval_cfg.eval_context_bsz, query_bsz,
                                    dev, score_quant=quant)
        return _metrics_from_score_matrices(
            *scores, _gt_on_device(queries, videos, dev), (0.7, 0.3))
    finally:
        model.train(was_training)
