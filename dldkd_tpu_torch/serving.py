"""Online retrieval serving: device-resident top-k search on one GPU or on
a device mesh (port of dldkd_tpu/serving.py).

Two index stores. 'encoded' (the default when it fits the device): the
corpus is encoded once into a device-resident index; each query batch is
encoded, scored against the whole corpus and reduced to its top k on the
device, so only k ids and scores per query reach the host. 'raw': only the
raw frame features stay on the device (in the model's compute dtype), and
each search encodes all its queries, then re-encodes the corpus block by
block (`stream_block` videos), scores each block against every query and
merges the blocks' top k (`_search_streaming`); the encoded frames never
exist beyond one block. The auto policy takes 'raw' when the encoded index
does not fit the device's free memory. Three routes, on either store:

- exact (default): both branches' frames, L2-normalized once at index
  time, scored with the masked-cosine kernel;
- two-stage (score_quant, rescore): stage 1 scores a prebuilt int8 index
  with the int8 kernel and keeps a shortlist of shortlist_factor * k videos
  per query; stage 2 rescores it exactly, either by gathering the
  candidates' stored frames (plain PyTorch) or by the exact-rescore kernel
  over the whole corpus (`dense_rescore_wins` decides from the shapes;
  DLDKD_DENSE_RESCORE=never|always pins it);
- int8-only (score_quant, rescore=False): the towers emit the int8 index
  directly and its int8 ranks are returned (ties broken by video id).

  retriever = Retriever.from_checkpoint(model_dir)
  retriever.index(packed_videos)     # or index_corpus(root, collection, ...)
  ids, scores = retriever.search(q_feats, q_mask, k=10)

Index artifacts (`save_index` / `load_index`, the JAX package's format,
`utils/index_io.py`): build the index once offline and start every serving
replica from it; an artifact of either package loads in the other. The
port's cold cost is the one-time nvcc build of the kernel libraries, not a
per-signature compile: `aot_cache_dir` names the directory those libraries
are built into and loaded from (`ops/kernels/build.set_build_dir`), which a
fleet shares, and a prewarm manifest (`save_index(prewarm=[(lq, k)])`)
records search signatures that each replica runs once at load.

  retriever.save_index("idx")            # offline, after index()
  replica.load_index("idx")              # instead of index()

CLI: python -m dldkd_tpu_torch.serving --model_dir <run> --root_path <root>
        --collection tvr --visual_feature i3d_resnet --queries q.npz --k 10
writes one JSON line per query: {"cap_id", "topk": [[video_id, score], ...]};
--save_index DIR (without --queries: build, write and exit), --load_index DIR
(with .npz or .hdf5 queries no dataset flags), --prewarm LQ:K[,...],
--aot_cache_dir DIR, --warm_start.

Corpus-sharded serving (`Retriever(mesh=parallel.Mesh)`, the JAX package's
mesh route; built on its own over every GPU when the caller names no GPU
and several are visible): the corpus rows are split into one contiguous
range per shard (`_mesh_place`), each shard's store is built on its device
as the single-device store is, each query batch is encoded once on the
mesh's first device and copied to the others, each shard keeps its own top
k, and the candidates merge on the first device in global row order, so
equal scores keep the lower video index, as on one device. Over a process
group (torchrun, one GPU a process) each rank builds its own shards and the
ranks' candidates are all-gathered and merged in rank order. Artifacts hold
canonical rows, so they cross between topologies.

  mesh = make_mesh(devices=["cpu"] * 4)        # make_mesh(): every GPU
  Retriever(model, mesh=mesh, device="cpu").index(videos)
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
import shutil
import sys
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from dldkd_tpu_torch import checkpoint as ckpt_lib
from dldkd_tpu_torch import resolve_device
from dldkd_tpu_torch.convert import load_jax_params
from dldkd_tpu_torch.data.ingest import PackedVideos
from dldkd_tpu_torch.evaluate import device_memory_budget, embed_corpus
from dldkd_tpu_torch.models import DLDKD
from dldkd_tpu_torch.ops.fast_eval import (encode_context_best,
                                           encode_query_best, tower_dtype,
                                           tower_weights)
from dldkd_tpu_torch.ops.kernels.query_tower import quantize_frames_q8
from dldkd_tpu_torch.ops.kernels.sim_max import build_q8_index, q8_index_bias
from dldkd_tpu_torch.ops.masking import l2_normalize
from dldkd_tpu_torch.ops.similarity import (clip_scores_maxpool,
                                            clip_scores_maxpool_pre8,
                                            dense_rescore_wins,
                                            exact_clip_scores,
                                            rescore_shortlist)
from dldkd_tpu_torch.parallel.mesh import Mesh, make_mesh
from dldkd_tpu_torch.parallel.multihost import (collective_device,
                                                default_mesh,
                                                maybe_initialize_distributed,
                                                process_device)
from dldkd_tpu_torch.utils import index_io
from dldkd_tpu_torch.utils.tracing import count, span, traced

SHORTLIST_FACTOR = 4  # default stage-1 candidates per result (k' = 4k)
# search keeps at most this many batches' results un-fetched: the oldest is
# forced to the host before the next batch uploads
_SEARCH_INFLIGHT_BATCHES = 8


@traced("serve/topk")
def topk_lowest_index(scores: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest scores per row, ties broken by
    the lower index first, as jax.lax.top_k breaks them (torch.topk
    promises no order among equal values). A stable descending sort."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _fuse(fusion, a: torch.Tensor, b: Optional[torch.Tensor]
          ) -> torch.Tensor:
    return a if b is None else fusion[0] * a + fusion[1] * b


def _rescore_stage2(s8, inher_q, explore_q, ctx_inher, ctx_explore, vmask,
                    fusion, k, k_out, shortlist_factor, plain=False):
    """Stage 2 of two-stage retrieval: exact f32 rescore of the int8 pass's
    k' = shortlist_factor * k shortlist, then the top k_out. The shortlist
    is capped at the frame buffers' row count (padded rows included; their
    masks are zero, so they never win).

    When the combined shortlists would re-read more stored-frame bytes
    than scoring the whole corpus exactly costs (`dense_rescore_wins`),
    every video is scored exactly instead and s8 is not used; the dense
    ranks are the gather's or better (no shortlist miss)."""
    k_short = min(shortlist_factor * k, ctx_inher.shape[0])
    if dense_rescore_wins(inher_q.shape[0], k_short, ctx_inher.shape[0],
                          ctx_inher.shape[1], ctx_inher.shape[2],
                          ctx_inher.element_size()):
        scores = _fuse(fusion, exact_clip_scores(inher_q, ctx_inher, vmask,
                                                 plain),
                       None if explore_q is None else exact_clip_scores(
                           explore_q, ctx_explore, vmask, plain))
        return topk_lowest_index(scores, k_out)
    _, cand = topk_lowest_index(s8, k_short)
    # ascending candidate order makes stage 2's lowest-index tie-break the
    # exact full-matrix path's (lowest video id wins)
    cand = torch.sort(cand, dim=1).values
    scores = _fuse(fusion, rescore_shortlist(inher_q, ctx_inher, vmask, cand),
                   None if explore_q is None else rescore_shortlist(
                       explore_q, ctx_explore, vmask, cand))
    top_scores, pos = topk_lowest_index(scores, k_out)
    return top_scores, torch.gather(cand, 1, pos)


def _two_stage_topk(inher_q, explore_q, ctx_inher, ctx_explore, vmask,
                    fusion, k, k_out, shortlist_factor=SHORTLIST_FACTOR,
                    plain=False):
    """int8 full-matrix prefilter (quantizing the frames per call) ->
    exact rescore of a k' = shortlist_factor * k shortlist -> top k_out.
    Ranks equal the exact path's whenever the exact top k_out all land in
    the int8 shortlist."""
    s8 = _fuse(fusion,
               clip_scores_maxpool(inher_q, ctx_inher, vmask, plain=plain,
                                   quantized=True),
               None if explore_q is None else clip_scores_maxpool(
                   explore_q, ctx_explore, vmask, plain=plain,
                   quantized=True))
    return _rescore_stage2(s8, inher_q, explore_q, ctx_inher, ctx_explore,
                           vmask, fusion, k, k_out, shortlist_factor, plain)


def _block_topk_core(inher_q, explore_q, ctx_i, ctx_e, block_mask, fusion,
                     k, k_out, quantized, rescore, shortlist_factor,
                     plain=False):
    """Fused-score top k_out of one encoded corpus block, indices local to
    the block (dldkd_tpu/serving.py:310-324): two-stage (quantized and
    rescore: the int8 pass quantizes the block's frames per call, then
    `_rescore_stage2`), int8-only (quantized) or exact."""
    if quantized and rescore:
        return _two_stage_topk(inher_q,
                               explore_q if ctx_e is not None else None,
                               ctx_i, ctx_e, block_mask, fusion, k, k_out,
                               shortlist_factor, plain)
    scores = _fuse(fusion,
                   clip_scores_maxpool(inher_q, ctx_i, block_mask,
                                       plain=plain, quantized=quantized),
                   None if ctx_e is None else clip_scores_maxpool(
                       explore_q, ctx_e, block_mask, plain=plain,
                       quantized=quantized))
    return topk_lowest_index(scores, k_out)


def _merge_block_topk(pairs, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global top k from the blocks' (scores, global indices) pairs:
    the global top k is a subset of the union of the blocks' top k. Blocks
    in corpus order, so equal scores keep the lower video index first, as
    topk_lowest_index breaks them."""
    vals = torch.cat([v for v, _ in pairs], dim=1)
    idx = torch.cat([i for _, i in pairs], dim=1)
    top, pos = topk_lowest_index(vals, k)
    return top, torch.gather(idx, 1, pos)


def _q8_topk(inher_q, explore_q, q8_i, q8_e, q8_bias, frames_i, frames_e,
             vmask, fusion, k, k_out, rescore, shortlist_factor,
             plain=False):
    """Top k_out of encoded queries against a prebuilt int8 index: stage
    1 straight on the index, then (rescore) stage 2 on the stored frames,
    or the raw int8 top k_out."""
    s8 = _fuse(fusion, clip_scores_maxpool_pre8(inher_q, q8_i, q8_bias, plain),
               None if explore_q is None else clip_scores_maxpool_pre8(
                   explore_q, q8_e, q8_bias, plain))
    if rescore:
        return _rescore_stage2(s8, inher_q, explore_q, frames_i,
                               frames_e if explore_q is not None else None,
                               vmask, fusion, k, k_out, shortlist_factor,
                               plain)
    return topk_lowest_index(s8, k_out)


def _exact_topk(inher_q, explore_q, cn_inher, cn_explore, vmask, fusion,
                k_out, plain=False):
    """Top k_out of encoded queries against L2-normalized frames."""
    scores = _fuse(fusion,
                   clip_scores_maxpool(inher_q, cn_inher, vmask,
                                       ctx_normalized=True, plain=plain),
                   None if explore_q is None else clip_scores_maxpool(
                       explore_q, cn_explore, vmask, ctx_normalized=True,
                       plain=plain))
    return topk_lowest_index(scores, k_out)


def _search_q8(model, weights, q_feats, q_mask, q8_i, q8_e, q8_bias, k,
               frames_i, frames_e, vmask, fusion, rescore=True,
               shortlist_factor=SHORTLIST_FACTOR, plain=False):
    """score_quant search of one query batch against the prebuilt int8
    index of one device."""
    inher_q, explore_q = encode_query_best(model, q_feats, q_mask, weights,
                                           plain)
    return _q8_topk(inher_q, explore_q, q8_i, q8_e, q8_bias, frames_i,
                    frames_e, vmask, fusion, k, k, rescore, shortlist_factor,
                    plain)


def _search(model, weights, q_feats, q_mask, cn_inher, cn_explore, k, vmask,
            fusion, plain=False):
    """Exact search of one query batch against L2-normalized frames of one
    device."""
    inher_q, explore_q = encode_query_best(model, q_feats, q_mask, weights,
                                           plain)
    return _exact_topk(inher_q, explore_q, cn_inher, cn_explore, vmask,
                       fusion, k, plain)


class _StagingSlot:
    """One host slot of serving's query staging: a flat f32 buffer each
    for a batch's features and mask (pinned for a CUDA device), viewed at
    each batch's shape and regrown only for a larger one, and the event of
    the last copy queued out of them."""

    def __init__(self, pin: bool):
        self.pin = pin
        self.bufs = [None, None]
        self.copied = None

    def fill(self, arrays, bsz: int) -> list:
        """The rows of each host array copied into the slot, once its last
        copy out has run; the views that hold them. A buffer holds bsz
        rows of its array's shape."""
        if self.copied is not None:
            self.copied.synchronize()
        for i, src in enumerate(arrays):
            need = bsz * math.prod(src.shape[1:])
            if self.bufs[i] is None or self.bufs[i].numel() < need:
                self.bufs[i] = torch.empty(need, pin_memory=self.pin)
        return [buf[:src.numel()].view(src.shape).copy_(src)
                for buf, src in zip(self.bufs, arrays)]

    def record(self, device: torch.device) -> None:
        """Mark the copies just queued out of the slot on the device's
        current stream (nothing to wait for off CUDA)."""
        if device.type == "cuda":
            if self.copied is None:
                self.copied = torch.cuda.Event()
            self.copied.record(torch.cuda.current_stream(device))


class _Shard:
    """Shard `index` of a mesh store, on `device`: the corpus rows [lo, lo
    + real), the real ones of its range (real 0: padding alone, no
    arrays), and its arrays under the single-device store's names, local
    row order. The raw store's rows are padded to whole stream blocks;
    the encoded and int8 stores hold the real rows alone, so every
    candidate is a real video."""

    def __init__(self, index: int, device: torch.device, lo: int,
                 real: int):
        self.index, self.device, self.lo, self.real = index, device, lo, real
        self.ctx_inher = self.ctx_explore = self.vmask = None
        self.q8_inher = self.q8_explore = self.q8_bias = None
        self.raw_feats = self.raw_mask = None


def _build_q8(store, plain: bool) -> None:
    """The stage-1 int8 index of a store's frames, built once
    (`store`: the Retriever or a mesh shard)."""
    store.q8_inher, store.q8_bias = build_q8_index(
        quantize_frames_q8(store.ctx_inher, plain), store.vmask)
    if store.ctx_explore is not None:
        store.q8_explore = build_q8_index(
            quantize_frames_q8(store.ctx_explore, plain), store.vmask)[0]


def _build_q8_sharded(shards, plain: bool) -> None:
    """Each shard's own int8 index from its frames, on its device (JAX
    `_build_q8_sharded_jit`)."""
    for sh in shards:
        _build_q8(sh, plain)


def _merge_shards(pairs, k: int, dev0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top k on dev0 of the shards' (scores, global indices) pairs,
    given in global row order (shard, then block): equal scores keep the
    lower video index, as one device breaks them."""
    return _merge_block_topk([(v.to(dev0), i.to(dev0)) for v, i in pairs],
                             k)


def _search_sharded(queries, shards, k: int, fusion, dev0, plain=False):
    """Exact search of one encoded query batch on the live shards of a
    mesh store (JAX `_search_sharded_jit`): each shard's top min(k, rows)
    of its L2-normalized frames, offset by its first row, merged on dev0.
    `queries`: {device: (inher, explore or None)} on each shard device."""
    pairs = []
    for sh in shards:
        vals, idx = _exact_topk(*queries[sh.device], sh.ctx_inher,
                                sh.ctx_explore, sh.vmask, fusion,
                                min(k, sh.real), plain)
        pairs.append((vals, idx + sh.lo))
    return _merge_shards(pairs, k, dev0)


def _search_q8_sharded(queries, shards, k: int, fusion, dev0, rescore,
                       shortlist_factor, plain=False):
    """score_quant search of one encoded query batch on the live shards
    (JAX `_search_q8_sharded_jit`): stage 1 on each shard's own int8
    index, then (rescore) stage 2 on its frames, keeping min(k, rows)
    candidates a shard; merged on dev0. The global top k is a subset of
    the union of the shards' top k."""
    pairs = []
    for sh in shards:
        vals, idx = _q8_topk(*queries[sh.device], sh.q8_inher,
                             sh.q8_explore, sh.q8_bias, sh.ctx_inher,
                             sh.ctx_explore, sh.vmask, fusion, k,
                             min(k, sh.real), rescore, shortlist_factor,
                             plain)
        pairs.append((vals, idx + sh.lo))
    return _merge_shards(pairs, k, dev0)


def _encoded_block_topk_sharded(model, weights, queries, sh: _Shard, start,
                                block: int, k: int, fusion, quantized,
                                rescore, shortlist_factor, plain=False):
    """Top min(k, rows) of rows [start, start + block) of a raw mesh
    shard (JAX `_encoded_block_topk_sharded_jit`): the block through the
    video towers on the shard's device, then `_block_topk_core` on its
    real rows alone; indices global (the shard's first row + start +
    local)."""
    bm = sh.raw_mask[start:start + block]
    ctx_i, ctx_e = encode_context_best(
        model, sh.raw_feats[start:start + block].float(), bm, weights,
        plain)
    real = min(block, sh.real - start)
    k_loc = min(k, real)
    vals, idx = _block_topk_core(
        *queries[sh.device], ctx_i[:real],
        None if ctx_e is None else ctx_e[:real], bm[:real], fusion, k_loc,
        k_loc, quantized, rescore, shortlist_factor, plain)
    return vals, idx + sh.lo + start


def _gather_ranks(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's t (equal shapes) concatenated on the leading axis in
    rank order, on t's device; sent as bytes, so any dtype crosses gloo
    and NCCL alike."""
    x = t.contiguous().view(torch.uint8).to(collective_device(group))
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts).view(t.dtype).to(t.device)


def _merge_ranks(scores: torch.Tensor, idx: torch.Tensor, k: int, group
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global top k from each rank's (Nq, <= k) merged candidates:
    padded to k columns that always lose, all-gathered, merged in rank
    order (rank r holds the shards after rank r - 1's)."""
    pad = k - scores.shape[1]
    scores = F.pad(scores, (0, pad), value=-float("inf"))
    idx = F.pad(idx, (0, pad))
    nq, world = scores.shape[0], dist.get_world_size(group)
    vals = _gather_ranks(scores, group).view(world, nq, k)
    ids = _gather_ranks(idx, group).view(world, nq, k)
    return _merge_block_topk(list(zip(vals, ids)), k)


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


def parse_prewarm(spec: str) -> List[Tuple[int, int]]:
    """'LQ:K[,LQ:K...]' -> [(lq, k), ...]; ValueError on a malformed
    spec."""
    out = []
    for part in spec.split(","):
        lq, k = part.split(":")
        out.append((int(lq), int(k)))
    return out


class Retriever:
    """Device-resident corpus index and batched top-k search, on one GPU or
    sharded over a mesh."""

    def __init__(self, model: DLDKD, query_bsz: int = 256,
                 fusion: Tuple[float, float] = (0.7, 0.3),
                 mesh=None, score_quant: bool = False,
                 rescore: bool = True, index_store: Optional[str] = None,
                 shortlist_factor: int = SHORTLIST_FACTOR,
                 stream_block: int = 2048,
                 warm_start: bool = False,
                 aot_cache_dir: Optional[str] = None,
                 device=None, plain: bool = False):
        """model: a DLDKD with its weights loaded. score_quant: stage-1
        scoring on int8 cosine components; with rescore=True (default)
        the int8 pass only proposes a shortlist and the returned top k is
        rescored in true f32 (ids equal to the exact path's whenever the
        exact top k lands in the shortlist; on a bf16 index the rescored
        ranks are finer than the bf16 exact path's), rescore=False returns
        the int8 ranks (~2.7e-3 score error, int8-grid ties broken by
        video id). index_store: 'encoded' (the encoded frames resident),
        'raw' (the raw frame features resident in the model's compute
        dtype, re-encoded in blocks of stream_block videos at each search)
        or None / 'auto' (encoded when it fits the device, else raw).
        device: where the index lives and search runs ("cuda" unless told
        otherwise).
        mesh: a `parallel.Mesh` to shard the corpus over (its first device
        encodes the queries and merges the shards' candidates; a device=
        other than that one raises). None: on a CUDA device given no index
        with several GPUs visible, `make_mesh()` over all of them (the JAX
        package's default); else one device. A mesh of one shard takes the
        sharded route too, as in the JAX package.
        plain=True runs every kernel's plain PyTorch version instead, on
        any device: the reference side of a kernel check.

        warm_start: accepted, and the results are those of a cold
        score_quant retriever. In the JAX package the exact path serves
        while the int8 search program compiles in a thread, then swaps to
        it (results after the swap are these). The port has no such
        detour: every route runs the same kernel libraries, built once per
        source hash, so no route compiles per search signature.
        aot_cache_dir: the directory the CUDA kernel libraries are built
        into and loaded from (`ops/kernels/build.set_build_dir`; default
        dldkd_tpu_torch/csrc/_build): a replica fleet points every replica
        at one directory, and the offline index build fills it."""
        if index_store not in (None, "auto", "encoded", "raw"):
            raise ValueError(f"index_store: {index_store!r}")
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh: want a parallel.Mesh, got "
                            f"{type(mesh).__name__}")
        if mesh is None:
            dev = resolve_device(device)
            if (dev.type == "cuda" and dev.index is None
                    and torch.cuda.device_count() > 1):
                mesh = make_mesh()
                dev = mesh.devices[0]
        else:
            dev = process_device(resolve_device(mesh.devices[0]))
            asked = torch.device(device if device is not None else dev)
            if asked.type != dev.type or asked.index not in (None,
                                                             dev.index):
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"device {dev}")
        if aot_cache_dir:
            from dldkd_tpu_torch.ops.kernels import build

            build.set_build_dir(aot_cache_dir)
        self.device = dev
        self.mesh = mesh
        self.model = model.eval()
        self.plain = bool(plain)
        # the towers' weights packed once per distinct device
        self.device_weights = {
            d: tower_weights(model, d) for d in dict.fromkeys(
                [dev] if mesh is None
                else [process_device(d) for d in mesh.devices])}
        self.weights = self.device_weights[dev]
        self.query_bsz = int(query_bsz)
        # the query batches' host slots, filled by _query_batches
        self._slots = [_StagingSlot(dev.type == "cuda") for _ in range(2)]
        self.score_quant = bool(score_quant)
        self.rescore = bool(rescore)
        self.shortlist_factor = int(shortlist_factor)
        self.stream_block = int(stream_block)
        if self.stream_block < 1:
            raise ValueError(f"stream_block: {stream_block}")
        self.index_store = None if index_store == "auto" else index_store
        # f32 fusion weights, as the JAX package's f32 fusion array
        self.fusion = tuple(float(np.float32(w)) for w in fusion)
        self._reset_index()

    @classmethod
    def from_checkpoint(cls, model_dir: str, **kw) -> "Retriever":
        """A retriever over the weights of `model_dir`/ckpt (the JAX
        package's checkpoint format, read without JAX)."""
        ckpt_dir = f"{model_dir}/ckpt"
        model = DLDKD(ckpt_lib.load_model_cfg(ckpt_dir))
        params, _ = ckpt_lib.restore_params_only(ckpt_dir)
        load_jax_params(model, params)
        return cls(model.eval(), **kw)

    def _reset_index(self) -> None:
        """Drop every array of a previously built index."""
        self.ctx_inher = self.ctx_explore = self.vmask = None
        self.q8_inher = self.q8_explore = self.q8_bias = None
        self.raw_feats = self.raw_mask = None
        # the stored frames are L2-normalized (the exact route's store)
        self.frames_normalized = False
        # the int8 index alone, no frames (int8-only index or artifact)
        self.q8_only = False
        self.video_ids: List[str] = []
        # a mesh store: this process's shards, and the raw store's rows
        # per shard
        self.shards: List[_Shard] = []
        self.raw_per_dev = 0

    def _mesh_place(self, n: int, per: int) -> List[_Shard]:
        """This process's shards of an n-row corpus, shard s holding the
        rows [s * per, (s + 1) * per) (JAX `_mesh_place`: the corpus
        padded to per * mesh size rows, one contiguous range a shard;
        `parallel.shard_rows` for per = ceil(n / size))."""
        return [_Shard(s, process_device(d), s * per,
                       max(0, min(per, n - s * per)))
                for s, d in self.mesh.local_shards()]

    def _live(self) -> List[_Shard]:
        """The shards that hold real rows."""
        return [sh for sh in self.shards if sh.real]

    def _index_bytes(self, n_rows: int) -> int:
        """Device bytes of an encoded index of n_rows videos (frames in
        the tower dtype, plus the int8 index beside them when rescoring,
        or the int8 index alone without rescore) and its build
        transients."""
        mcfg = self.model.config
        itemsize = torch.tensor([], dtype=tower_dtype(mcfg)).element_size()
        if self.score_quant:
            itemsize = itemsize + 1 if self.rescore else 1
        hiddens = [mcfg.inheritance_hidden] + (
            [mcfg.exploration_hidden] if mcfg.double_branch else [])
        ctx = sum(n_rows * mcfg.max_ctx_l * h * itemsize for h in hiddens)
        return 2 * ctx + 256 * 1024 * 1024

    def auto_index_store(self, n_videos: int) -> str:
        """'encoded' when the encoded index fits the free memory of every
        device that holds it, else 'raw'. On a mesh each device holds
        ceil(n / size) rows for each shard it carries (JAX
        dldkd_tpu/serving.py:564-575, shards sharing a device counted
        together), and the ranks of a process group agree on the store.
        A device that reports no budget (the CPU) keeps 'encoded'."""
        rows = {self.device: n_videos}
        if self.mesh is not None:
            per = -(-n_videos // self.mesh.size)
            rows = {}
            for _, d in self.mesh.local_shards():
                d = process_device(d)
                rows[d] = rows.get(d, 0) + per
        raw = False
        for d, r in rows.items():
            budget = device_memory_budget(d)
            raw |= budget is not None and self._index_bytes(r) > budget
        if self.mesh is not None and self.mesh.group is not None:
            flag = torch.tensor([int(raw)],
                                device=collective_device(self.mesh.group))
            dist.all_reduce(flag, op=dist.ReduceOp.MAX,
                            group=self.mesh.group)
            raw = bool(flag.item())
        return "raw" if raw else "encoded"

    @torch.no_grad()
    def index(self, videos: PackedVideos, context_bsz: int = 200) -> None:
        """Build the device-resident index of `videos`. Raw store: the raw
        frame features in the model's compute dtype and their mask, padded
        with zero rows to a whole number of stream blocks
        (dldkd_tpu/serving.py:589-612, one device). Encoded store: the int8
        index alone (score_quant without rescore: the towers emit it), the
        stored frames plus an int8 index built from them (two-stage), or
        the L2-normalized frames (exact)."""
        self._reset_index()
        store = self.index_store or self.auto_index_store(len(videos))
        self.index_store = store
        self.video_ids = list(videos.ids)
        if store == "raw":
            self._place_raw(videos.feats, videos.mask)
            return
        self.q8_only = self.score_quant and not self.rescore
        if self.mesh is not None:
            self._index_sharded(videos, context_bsz)
        else:
            args = (self.model, videos, context_bsz, self.device,
                    self.weights, self.plain)
            if self.q8_only:
                self.q8_inher, self.q8_explore, self.q8_bias = \
                    embed_corpus(*args, score_quant=True)
            else:
                ctx_i, ctx_e, self.vmask = embed_corpus(*args)
                self._set_frames(ctx_i, ctx_e, normalized=False)

    def _index_sharded(self, videos: PackedVideos, context_bsz: int) -> None:
        """The encoded mesh store (JAX dldkd_tpu/serving.py:640-672): each
        shard's rows through the single-device build on its device, in
        context_bsz batches, cut to the real rows: the int8 index alone
        from the towers' epilogue (score_quant without rescore), or the
        frames, then `_set_shard_frames`. Padding-only shards are
        skipped."""
        n = len(videos)
        self.shards = self._mesh_place(n, -(-n // self.mesh.size))
        frames = []
        for sh in self._live():
            part = PackedVideos(videos.feats[sh.lo:sh.lo + sh.real],
                                videos.mask[sh.lo:sh.lo + sh.real],
                                videos.ids[sh.lo:sh.lo + sh.real])
            args = (self.model, part, context_bsz, sh.device,
                    self.device_weights[sh.device], self.plain)
            if self.q8_only:
                rows_i, rows_e, bias = embed_corpus(*args, score_quant=True)
                sh.q8_inher, sh.q8_bias = rows_i[:sh.real], bias[:sh.real]
                sh.q8_explore = None if rows_e is None else rows_e[:sh.real]
            else:
                ctx_i, ctx_e, vmask = embed_corpus(*args)
                frames.append((ctx_i[:sh.real], None if ctx_e is None
                               else ctx_e[:sh.real], vmask[:sh.real]))
        if frames:
            self._set_shard_frames(frames, normalized=False)

    def _set_shard_frames(self, frames, normalized: bool) -> None:
        """Each live shard's encoded store from its (frames inher, frames
        explore or None, mask) on its device, as `_set_frames` builds the
        single-device one; two-stage then builds each shard's int8 index
        (`_build_q8_sharded`)."""
        for sh, (ctx_i, ctx_e, vmask) in zip(self._live(), frames):
            sh.vmask = vmask
            norm = ((lambda t: t) if normalized or self.score_quant
                    else l2_normalize)
            sh.ctx_inher = norm(ctx_i)
            sh.ctx_explore = None if ctx_e is None else norm(ctx_e)
        self.frames_normalized = normalized or not self.score_quant
        if self.score_quant:
            _build_q8_sharded(self._live(), self.plain)

    def _place_raw(self, feats, mask) -> None:
        """The raw store from (N, L, D) frame features (numpy, or a tensor
        in any float dtype) and their (N, L) mask: features in the model's
        compute dtype, padded with zero rows to a whole number of stream
        blocks (dldkd_tpu/serving.py:589-639), copied a block at a time
        (no corpus-sized f32 copy on the device). On a mesh each shard
        owns raw_per_dev rows, ceil(N / size) rounded up to whole blocks,
        and holds its real ones, padded to whole blocks, on its device."""
        n, sb = feats.shape[0], self.stream_block
        if self.mesh is None:
            self.raw_feats, self.raw_mask = self._raw_rows(feats, mask,
                                                           self.device)
            return
        self.raw_per_dev = -(-(-(-n // self.mesh.size)) // sb) * sb
        self.shards = self._mesh_place(n, self.raw_per_dev)
        for sh in self._live():
            rows = slice(sh.lo, sh.lo + sh.real)
            sh.raw_feats, sh.raw_mask = self._raw_rows(feats[rows],
                                                       mask[rows], sh.device)

    def _raw_rows(self, feats, mask, device):
        """(features in the compute dtype, f32 mask) of the rows on
        `device`, zero rows appended up to whole stream blocks."""
        n, sb = feats.shape[0], self.stream_block
        n_pad = -(-n // sb) * sb
        raw_feats = torch.zeros((n_pad,) + tuple(feats.shape[1:]),
                                dtype=tower_dtype(self.model.config),
                                device=device)
        raw_mask = torch.zeros((n_pad,) + tuple(mask.shape[1:]),
                               dtype=torch.float32, device=device)
        for s in range(0, n, sb):
            block = _as_tensor(feats[s:s + sb])
            raw_feats[s:s + block.shape[0]].copy_(block)
        raw_mask[:n] = _as_tensor(mask).float()
        return raw_feats, raw_mask

    def _set_frames(self, ctx_i, ctx_e, normalized: bool) -> None:
        """The encoded store from stored frames (Np, L, H) on the device
        and self.vmask. Two-stage: the frames as they are (stage 2 reads
        them) and an int8 index built from them once, here. Exact: the
        frames L2-normalized once (unless they already are), not per
        search."""
        if self.score_quant:
            self.ctx_inher, self.ctx_explore = ctx_i, ctx_e
            self.frames_normalized = normalized
            _build_q8(self, self.plain)
        else:
            norm = (lambda t: t) if normalized else l2_normalize
            self.ctx_inher = norm(ctx_i)
            self.ctx_explore = norm(ctx_e) if ctx_e is not None else None
            self.frames_normalized = True

    def index_corpus(self, root_path: str, collection: str,
                     visual_feature: str, split: str = "test") -> None:
        from dldkd_tpu_torch.data import BigFile, pack_video_corpus, read_dict
        from dldkd_tpu_torch.data.ingest import dataset_paths, read_video_ids

        paths = dataset_paths(root_path, collection, visual_feature)
        videos = pack_video_corpus(
            read_video_ids(paths["cap_file"][split]),
            BigFile(paths["visual_feat_dir"]),
            read_dict(paths["video2frames"]),
            max_ctx_l=self.model.config.max_ctx_l)
        self.index(videos)

    # ---------------------------------------------------- index artifacts

    def save_index(self, path: str,
                   prewarm: Optional[List[Tuple[int, int]]] = None) -> None:
        """Write the built index as an artifact (build once offline, load
        in every serving replica): meta.json and one .npy per array, the
        JAX package's format (dldkd_tpu/serving.py:768-905), written to a
        staging directory and swapped into place whole
        (`index_io.publish_dir`), so a re-save never mixes new arrays with
        the old meta.json.

        What is written, real rows only, by the store that was built:
        - 'encoded': ctx_inher, ctx_explore (frames in the tower dtype) and
          vmask. The two-stage store's frames are the towers' own, as the
          JAX package stores them; the exact store's are L2-normalized (the
          port keeps no other copy), marked by "frames_normalized": true in
          meta.json so that the port does not normalize them again on load
          (the JAX package ignores the key and normalizes them per search).
          The stage-1 int8 companions are not written: load_index rebuilds
          them through the epilogue kernel.
        - int8-only: q8_rows_inher, q8_rows_explore (Nv, L, H) int8 and
          q8_mask (Nv, L) uint8, canonical rows: the port's index is already
          in that layout.
        - 'raw': raw_feats in the compute dtype and raw_mask.
        A mesh store writes the same canonical rows (`_q8_canonical_rows`,
        `_raw_canonical_rows`), so an artifact does not depend on the
        topology that built it; over a process group the ranks' rows are
        gathered and rank 0 writes.

        prewarm: (lq, k) search signatures at this retriever's query_bsz,
        each run once now through this retriever's route (which builds the
        kernel libraries and warms the allocator at that shape) and
        recorded as meta.json's `prewarm_signatures` [[query_bsz, lq, k],
        ...]; every replica that loads the artifact runs them once too.
        Needs the prebuilt int8 index (score_quant), as in the JAX
        package."""
        if not self.video_ids:
            raise RuntimeError("call index()/index_corpus() first")
        if prewarm and not self._has_q8_index():
            # before writing: the corpus arrays are the artifact's bulk
            raise ValueError("prewarm needs the prebuilt int8 index "
                             "(score_quant=True)")
        mode, arrays, meta = self._index_payload()
        if prewarm:
            meta["prewarm_signatures"] = self._prewarm(prewarm)
        group = None if self.mesh is None else self.mesh.group
        if group is None or dist.get_rank(group) == 0:
            stage = f"{path}.staging.{os.getpid()}"
            shutil.rmtree(stage, ignore_errors=True)
            os.makedirs(stage)
            try:
                manifest: dict = {}
                for name, t in arrays.items():
                    index_io.save_array(stage, name, t, manifest)
                index_io.write_meta(stage, dict(
                    mode=mode, arrays=manifest, n_videos=len(self.video_ids),
                    video_ids=list(self.video_ids),
                    model_config=repr(self.model.config),
                    params_fingerprint=index_io.params_fingerprint(
                        self.model), **meta))
            except BaseException:
                shutil.rmtree(stage, ignore_errors=True)
                raise
            index_io.publish_dir(stage, path)
        if group is not None:
            dist.barrier(group)

    def _has_q8_index(self) -> bool:
        """The store holds a prebuilt int8 index (score_quant, encoded)."""
        return self.score_quant and self.index_store == "encoded"

    def _index_payload(self):
        """(mode, {array name: canonical rows}, meta.json extras) of the
        built store."""
        if self.index_store == "raw":
            feats, mask = self._raw_canonical_rows()
            return "raw", {"raw_feats": feats, "raw_mask": mask}, {}
        if self.q8_only:
            rows_i, rows_e, mask = self._q8_canonical_rows()
            arrays = {"q8_rows_inher": rows_i, "q8_rows_explore": rows_e,
                      "q8_mask": mask}
            return "q8", {k: v for k, v in arrays.items()
                          if v is not None}, {}
        arrays = {name: self._canonical_rows(name)
                  for name in ("ctx_inher", "ctx_explore", "vmask")}
        return ("encoded", {k: v for k, v in arrays.items() if v is not None},
                {"frames_normalized": True} if self.frames_normalized else {})

    def _canonical_rows(self, name: str) -> Optional[torch.Tensor]:
        """The store's array `name` as real rows in corpus order (None
        where the store has none): one device's first n rows; on a mesh
        the live shards' real rows concatenated in shard order on the CPU,
        over a process group every rank's, gathered in rank order."""
        if self.mesh is None:
            t = getattr(self, name)
            return None if t is None else t[:len(self.video_ids)]
        parts = [getattr(sh, name) for sh in self._live()]
        local = None if not parts or parts[0] is None else torch.cat(
            [t[:sh.real].cpu() for t, sh in zip(parts, self._live())])
        if self.mesh.group is None:
            return local
        every = [None] * self.mesh.n_processes
        dist.all_gather_object(every, local, group=self.mesh.group)
        every = [t for t in every if t is not None]
        return torch.cat(every) if every else None

    def _q8_canonical_rows(self):
        """(rows inher (Nv, L, H) int8, rows explore or None, mask (Nv, L)
        uint8) of the int8-only store, real rows in corpus order (JAX
        `_q8_canonical_rows`): the device-count-independent artifact
        payload; the mask comes back from the bias (0: a valid frame)."""
        bias = self._canonical_rows("q8_bias")
        return (self._canonical_rows("q8_inher"),
                self._canonical_rows("q8_explore"),
                (bias == 0).to(torch.uint8))

    def _raw_canonical_rows(self):
        """(features (Nv, L, D) in the compute dtype, mask (Nv, L) f32) of
        the raw store in corpus order (JAX `_raw_canonical_rows`): a mesh
        store's shards hold consecutive row ranges, so their real rows
        concatenated are the corpus."""
        return (self._canonical_rows("raw_feats"),
                self._canonical_rows("raw_mask"))

    def _warm(self, lq: int, k: int) -> None:
        """One search of query_bsz zero queries of lq tokens at k."""
        f = np.zeros((self.query_bsz, lq, self.model.config.query_input_size),
                     np.float32)
        self.search(f, np.ones((self.query_bsz, lq), np.float32), k)

    def _prewarm(self, signatures: List[Tuple[int, int]]) -> list:
        """Run each (lq, k) signature once; the manifest rows."""
        if not self._has_q8_index():
            raise ValueError("prewarm needs the prebuilt int8 index "
                             "(score_quant=True)")
        rows = []
        for lq, k in signatures:
            self._warm(int(lq), int(k))
            rows.append([self.query_bsz, int(lq), int(k)])
        return rows

    def _adopt_prewarm(self, meta: dict) -> None:
        """Run every manifest signature of this retriever's batch size once
        (the JAX package loads their compiled executables here)."""
        for bsz, lq, k in meta.get("prewarm_signatures") or []:
            if int(bsz) == self.query_bsz:
                self._warm(int(lq), int(k))

    def _rows_on_device(self, t: torch.Tensor, n_rows: int) -> torch.Tensor:
        """t's rows on the device, zero rows appended up to n_rows."""
        out = torch.zeros((n_rows,) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=self.device)
        out[:t.shape[0]].copy_(t)
        return out

    @torch.no_grad()
    def load_index(self, path: str, strict: bool = True,
                   context_bsz: int = 200) -> None:
        """Restore a save_index artifact of either package instead of
        encoding the corpus (dldkd_tpu/serving.py:930-1063).
        strict=True refuses an artifact whose params fingerprint or model
        config differs from this retriever's (it would serve wrong
        results); strict=False loads it with a warning. Loading replaces
        any index built before.

        The arrays are placed as index() places them: the encoded and
        int8 stores' rows padded with zero rows to index()'s context_bsz
        grid (give the context_bsz the index was built with), the raw
        store to whole stream blocks. An encoded artifact serves every
        route: the exact route normalizes its frames once, here (unless
        meta.json says they are), exactly as index() does after the
        towers; score_quant rebuilds the stage-1 int8 companions through
        the epilogue kernel, as index() builds them. An int8-only artifact
        serves only score_quant=True, rescore=False: it has no frames;
        its rows are trimmed to the model's max_ctx_l frames where the
        JAX package padded them to its frame tile with masked frames.
        On a mesh the rows are laid out again per shard, whatever topology
        wrote them: each shard takes its real rows alone (the raw store:
        padded to whole blocks), the exact frames are normalized and the
        int8 indexes built per shard; over a process group each rank keeps
        its own shards' rows."""
        meta = index_io.read_meta(path)
        if (meta["params_fingerprint"]
                != index_io.params_fingerprint(self.model)
                or meta["model_config"] != repr(self.model.config)):
            msg = (f"index at {path} was built with different "
                   f"weights/config than this retriever's")
            if strict:
                raise ValueError(msg + " (strict=False to force)")
            logging.getLogger(__name__).warning("%s; loading anyway", msg)
        mode = meta["mode"]
        if mode == "q8" and not (self.score_quant and not self.rescore):
            raise ValueError(
                "an int8-only index has no frame features: it serves only "
                "score_quant=True, rescore=False retrievers")
        arrays = {name: index_io.load_array(path, name, dt)
                  for name, dt in meta["arrays"].items()}
        n = int(meta["n_videos"])
        n_ctx = -(-n // context_bsz) * context_bsz
        self._reset_index()
        if mode == "raw":
            self.index_store = "raw"
            self._place_raw(arrays["raw_feats"], arrays["raw_mask"])
        elif mode == "q8":
            self.index_store = "encoded"
            self.q8_only = True
            rows_i, mask = arrays["q8_rows_inher"], arrays["q8_mask"]
            rows_e = arrays.get("q8_rows_explore")
            l_model = self.model.config.max_ctx_l
            if mask.shape[1] > l_model and not mask[:, l_model:].any():
                # the JAX index's frame-tile padding: masked frames only
                rows_i, mask = rows_i[:, :l_model], mask[:, :l_model]
                rows_e = None if rows_e is None else rows_e[:, :l_model]
            if self.mesh is not None:
                self._load_q8_sharded(rows_i, rows_e, mask)
                self.video_ids = list(meta["video_ids"])
                self._adopt_prewarm(meta)
                return
            self.q8_inher = self._rows_on_device(rows_i.contiguous(), n_ctx)
            if rows_e is not None:
                self.q8_explore = self._rows_on_device(rows_e.contiguous(),
                                                       n_ctx)
            self.q8_bias = q8_index_bias(
                self._rows_on_device(mask.float(), n_ctx)).contiguous()
        elif self.mesh is not None:
            self.index_store = "encoded"
            self.shards = self._mesh_place(n, -(-n // self.mesh.size))
            ctx_e = arrays.get("ctx_explore")
            self._set_shard_frames(
                [(arrays["ctx_inher"][sh.lo:sh.lo + sh.real].to(sh.device),
                  None if ctx_e is None
                  else ctx_e[sh.lo:sh.lo + sh.real].to(sh.device),
                  arrays["vmask"][sh.lo:sh.lo + sh.real].float()
                  .to(sh.device)) for sh in self._live()],
                normalized=bool(meta.get("frames_normalized", False)))
        else:
            self.index_store = "encoded"
            self.vmask = self._rows_on_device(arrays["vmask"].float(), n_ctx)
            ctx_e = arrays.get("ctx_explore")
            self._set_frames(
                self._rows_on_device(arrays["ctx_inher"], n_ctx),
                None if ctx_e is None else self._rows_on_device(ctx_e,
                                                                n_ctx),
                normalized=bool(meta.get("frames_normalized", False)))
        self.video_ids = list(meta["video_ids"])
        self._adopt_prewarm(meta)

    def _load_q8_sharded(self, rows_i, rows_e, mask) -> None:
        """Each live shard's int8 index from canonical int8 rows and their
        mask: its real rows on its device, the bias rebuilt (no
        quantization: the rows are the stored int8 values)."""
        n = rows_i.shape[0]
        self.shards = self._mesh_place(n, -(-n // self.mesh.size))
        for sh in self._live():
            rows = slice(sh.lo, sh.lo + sh.real)
            sh.q8_inher = rows_i[rows].contiguous().to(sh.device)
            sh.q8_explore = (None if rows_e is None
                             else rows_e[rows].contiguous().to(sh.device))
            sh.q8_bias = q8_index_bias(
                mask[rows].float().to(sh.device)).contiguous()

    def _search_batch(self, f: torch.Tensor, m: torch.Tensor, k: int):
        """The top k of one query batch: encoded once on self.device, then
        scored on the single-device store or on every live shard."""
        if self.mesh is None:
            if self.q8_inher is not None:
                return _search_q8(self.model, self.weights, f, m,
                                  self.q8_inher, self.q8_explore,
                                  self.q8_bias, k, self.ctx_inher,
                                  self.ctx_explore, self.vmask, self.fusion,
                                  self.rescore, self.shortlist_factor,
                                  self.plain)
            return _search(self.model, self.weights, f, m, self.ctx_inher,
                           self.ctx_explore, k, self.vmask, self.fusion,
                           self.plain)
        q_i, q_e = encode_query_best(self.model, f, m, self.weights,
                                     self.plain)
        live = self._live()
        if not live:
            return self._no_candidates(f.shape[0])
        queries = self._queries_on_shards(q_i, q_e)
        if self.score_quant:
            return _search_q8_sharded(queries, live, k, self.fusion,
                                      self.device, self.rescore,
                                      self.shortlist_factor, self.plain)
        return _search_sharded(queries, live, k, self.fusion, self.device,
                               self.plain)

    def _queries_on_shards(self, q_i, q_e) -> dict:
        """{shard device: (inher, explore or None)}: the encoded queries
        copied once to each distinct device of this process's shards."""
        return {d: (q_i.to(d), None if q_e is None else q_e.to(d))
                for d in dict.fromkeys(sh.device for sh in self.shards)}

    def _no_candidates(self, nq: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The (Nq, 0) result of a process whose shards are all padding."""
        return (torch.empty((nq, 0), device=self.device),
                torch.empty((nq, 0), dtype=torch.long, device=self.device))

    def _query_batches(self, q_feats: np.ndarray, q_mask: np.ndarray):
        """The queries in serving batches of query_bsz f32 rows on the
        device. Each batch's real rows go through a host slot (the two
        alternate; a slot is refilled once its last copy has run) and one
        non-blocking copy; its padding rows are zeroed on the device. The
        copy and the zeroing are queued on the stream the kernels run on,
        so the allocator hands out no memory that queued kernels still
        read."""
        bsz, dev = self.query_bsz, self.device
        # views of the caller's arrays: each batch's rows are copied once,
        # into a slot
        feats, mask = torch.as_tensor(q_feats), torch.as_tensor(q_mask)
        for b, start in enumerate(range(0, feats.shape[0], bsz)):
            with span("serve/h2d"):
                slot = self._slots[b % 2]
                rows = slot.fill((feats[start:start + bsz],
                                  mask[start:start + bsz]), bsz)
                out = []
                for host in rows:
                    t = torch.empty((bsz,) + tuple(host.shape[1:]),
                                    device=dev)
                    t[:host.shape[0]].copy_(host, non_blocking=True)
                    t[host.shape[0]:].zero_()
                    out.append(t)
                slot.record(dev)
                count("serve.h2d_bytes",
                      sum(h.numel() * h.element_size() for h in rows))
                count("serve.padded_rows", bsz - rows[0].shape[0])
            yield out[0], out[1]

    def _search_streaming(self, q_feats: np.ndarray, q_mask: np.ndarray,
                          k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Raw-store search (dldkd_tpu/serving.py:1065-1131): encode all
        queries first, in serving batches with the same backpressure as
        the encoded store's search; then stream each raw corpus block once
        through the video towers (a bf16 block widened to f32, as the
        Pallas tower widens its input) and `_block_topk_core` against
        every query; merge the blocks' top k. One corpus pass per call,
        whatever the query count. On a mesh the blocks are each shard's
        (`_sharded_raw_block_topks`)."""
        rows_i, rows_e, done = [], [], []
        for f, m in self._query_batches(q_feats, q_mask):
            # at most _SEARCH_INFLIGHT_BATCHES encodes pending: wait for
            # the oldest before this batch uploads
            if len(done) >= _SEARCH_INFLIGHT_BATCHES:
                done[len(done) - _SEARCH_INFLIGHT_BATCHES].synchronize()
            q_i, q_e = encode_query_best(self.model, f, m, self.weights,
                                         self.plain)
            rows_i.append(q_i)
            if q_e is not None:
                rows_e.append(q_e)
            if self.device.type == "cuda":
                done.append(torch.cuda.Event())
                done[-1].record(torch.cuda.current_stream(self.device))
        inher_q = torch.cat(rows_i)
        explore_q = torch.cat(rows_e) if rows_e else None
        if self.mesh is not None:
            if not self._live():
                return self._no_candidates(inher_q.shape[0])
            return _merge_shards(self._sharded_raw_block_topks(
                self._queries_on_shards(inher_q, explore_q), k), k,
                self.device)
        sb = self.stream_block
        k_blk = min(k, sb)
        pairs = []
        for b in range(0, self.raw_feats.shape[0], sb):
            bm = self.raw_mask[b:b + sb]
            ctx_i, ctx_e = encode_context_best(
                self.model, self.raw_feats[b:b + sb].float(), bm,
                self.weights, self.plain)
            vals, idx = _block_topk_core(
                inher_q, explore_q, ctx_i, ctx_e, bm, self.fusion, k_blk,
                k_blk, self.score_quant, self.rescore, self.shortlist_factor,
                self.plain)
            pairs.append((vals, idx + b))
            del ctx_i, ctx_e   # one encoded block alive at a time
        return _merge_block_topk(pairs, k)

    def _sharded_raw_block_topks(self, queries, k: int) -> list:
        """Raw+mesh search (JAX `_sharded_raw_block_topks`): block j of
        every live shard in turn through `_encoded_block_topk_sharded`;
        the (scores, global indices) pairs in global row order (shard,
        then block), so the merge breaks ties as one device does. (The
        JAX package merges in (block, device) order, which can put a
        higher video id first on an exact int8 tie.)"""
        sb, live = self.stream_block, self._live()
        pairs = {sh.index: [] for sh in live}
        for start in range(0, max(sh.real for sh in live), sb):
            for sh in live:
                if start < sh.real:
                    pairs[sh.index].append(_encoded_block_topk_sharded(
                        self.model, self.device_weights[sh.device], queries,
                        sh, start, sb, k, self.fusion, self.score_quant,
                        self.rescore, self.shortlist_factor, self.plain))
        return [p for sh in live for p in pairs[sh.index]]

    @torch.no_grad()
    def search(self, q_feats: np.ndarray, q_mask: np.ndarray, k: int = 10
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(scores (Nq, k) f32, indices (Nq, k)) over the indexed corpus.
        Queries are padded to the serving batch size internally. Over a
        process group every rank calls it with the same queries and
        returns the same result."""
        if not self.video_ids:
            raise RuntimeError("call index()/index_corpus() first")
        k = min(k, len(self.video_ids))
        n = q_feats.shape[0]
        if self.index_store == "raw":
            found = self._search_streaming(q_feats, q_mask, k)
            with span("serve/d2h"):
                scores, idx = (t.cpu() for t in found)
        else:
            out: list = []
            for f, m in self._query_batches(q_feats, q_mask):
                # backpressure before this batch uploads: forcing the
                # oldest un-fetched result drains its batch, so at most
                # _SEARCH_INFLIGHT_BATCHES batches are pending on the
                # device
                if len(out) >= _SEARCH_INFLIGHT_BATCHES:
                    w = len(out) - _SEARCH_INFLIGHT_BATCHES
                    with span("serve/d2h"):
                        out[w] = tuple(t.cpu() for t in out[w])
                out.append(self._search_batch(f, m, k))
            with span("serve/d2h"):
                scores = torch.cat([s.cpu() for s, _ in out])
                idx = torch.cat([i.cpu() for _, i in out])
        if self.mesh is not None and self.mesh.group is not None:
            scores, idx = _merge_ranks(scores, idx, k, self.mesh.group)
        return scores.numpy()[:n], idx.numpy()[:n]

    def search_ids(self, q_feats, q_mask, k: int = 10
                   ) -> List[List[Tuple[str, float]]]:
        scores, idx = self.search(q_feats, q_mask, k)
        return [[(self.video_ids[int(j)], float(s))
                 for j, s in zip(row_i, row_s)]
                for row_i, row_s in zip(idx, scores)]


def _read_query_store(path: str, max_desc_l: int):
    """(cap_ids, feats, mask) of every caption in a feature store (HDF5, or
    its .npz twin where only that exists), packed to the query towers'
    8-token grid. Caption ids in name order, as h5py lists them."""
    from dldkd_tpu_torch.data.ingest import (_feature_file, open_features,
                                             pack_query_rows)

    with open_features(_feature_file(path)) as f:
        cap_ids = sorted(f.keys())
        feats, mask = pack_query_rows(f, cap_ids, max_desc_l,
                                      pad_to_multiple=8)
    return cap_ids, feats, mask


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--model_dir", required=True)
    p.add_argument("--root_path", default="",
                   help="dataset root (not needed with --load_index and "
                        ".npz/.hdf5 --queries: the artifact replaces the "
                        "dataset)")
    p.add_argument("--collection", default="")
    p.add_argument("--visual_feature", default="")
    p.add_argument("--split", default="test")
    p.add_argument("--queries", default="",
                   help="feature store of cap_id -> (Lq, Dq) RoBERTa token "
                        "features (.hdf5, or its .npz twin), or a caption "
                        "file to look ids up in the standard TextData store "
                        "(optional with --save_index: build and write the "
                        "index artifact, then exit)")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--out", default="-")
    p.add_argument("--score_quant", action="store_true",
                   help="int8 first-pass scoring; exact f32 rescoring of "
                        "the shortlist keeps results identical to the exact "
                        "path as long as the true top k all land in the int8 "
                        "shortlist (factor * k candidates)")
    p.add_argument("--no_rescore", action="store_true",
                   help="with --score_quant: skip the exact rescoring stage "
                        "and return raw int8 ranks")
    p.add_argument("--shortlist_factor", type=int, default=SHORTLIST_FACTOR,
                   help="stage-1 candidates per result (k' = factor * k)")
    p.add_argument("--index_store", choices=["auto", "encoded", "raw"],
                   default="auto",
                   help="'encoded' keeps the encoded frames on the device; "
                        "'raw' keeps only the raw frame features there and "
                        "re-encodes them in blocks at each search (less "
                        "memory only where the raw width is below the "
                        "encoded one); 'auto' (default) takes 'encoded' "
                        "when it fits the device's free memory, else 'raw'")
    p.add_argument("--stream_block", type=int, default=2048,
                   help="videos per re-encoded block for --index_store raw")
    p.add_argument("--torch_device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--warm_start", action="store_true",
                   help="accepted for the JAX CLI's flag; results are those "
                        "of a cold --score_quant retriever (the JAX package "
                        "serves the exact path while its int8 program "
                        "compiles, then swaps; the port compiles no program "
                        "per search, so there is nothing to bridge)")
    p.add_argument("--aot_cache_dir", default="", metavar="DIR",
                   help="build the CUDA kernel libraries into DIR and load "
                        "them from there (default "
                        "dldkd_tpu_torch/csrc/_build); replicas that share "
                        "DIR with the offline --save_index build start "
                        "without compiling")
    p.add_argument("--save_index", default="", metavar="DIR",
                   help="after building the index, write it under DIR "
                        "(Retriever.save_index): an offline build step; "
                        "serving replicas then start with --load_index")
    p.add_argument("--load_index", default="", metavar="DIR",
                   help="load a --save_index artifact (of this package or "
                        "of dldkd_tpu) instead of building the index from "
                        "the dataset (refuses one built with other weights)")
    p.add_argument("--prewarm", default="", metavar="LQ:K[,LQ:K...]",
                   help="with --save_index and --score_quant: run one "
                        "search of each lq:k signature now and record them "
                        "in the artifact; replicas that load it run them "
                        "once at load")
    args = p.parse_args(argv)
    if not args.queries and not args.save_index:
        p.error("--queries is required unless --save_index builds an "
                "index artifact and exits")
    needs_dataset = (not args.load_index
                     or (args.queries and not args.queries.endswith(
                         (".hdf5", ".h5", ".npz"))))
    if needs_dataset and not (args.root_path and args.collection
                              and args.visual_feature):
        p.error("--root_path/--collection/--visual_feature are required "
                "when building the index or resolving caption-file "
                "queries")
    # the --prewarm checks run before any corpus work
    if args.prewarm and not args.score_quant:
        p.error("--prewarm needs --score_quant (the prebuilt int8 index)")
    if args.prewarm and not args.save_index:
        p.error("--prewarm only applies to --save_index artifact builds")
    prewarm = None
    if args.prewarm:
        try:
            prewarm = parse_prewarm(args.prewarm)
        except ValueError:
            p.error(f"--prewarm {args.prewarm!r}: expected LQ:K[,LQ:K...] "
                    "with integer fields")

    # the corpus sharded over the processes of a group (torchrun), or over
    # every visible GPU of this process (as infer.main shards its eval)
    maybe_initialize_distributed(args.torch_device)  # no-op without torchrun
    mesh = default_mesh(resolve_device(args.torch_device))
    r = Retriever.from_checkpoint(args.model_dir,
                                  score_quant=args.score_quant,
                                  rescore=not args.no_rescore,
                                  shortlist_factor=args.shortlist_factor,
                                  index_store=args.index_store,
                                  stream_block=args.stream_block,
                                  warm_start=args.warm_start,
                                  aot_cache_dir=args.aot_cache_dir or None,
                                  mesh=mesh, device=args.torch_device)
    if args.load_index:
        r.load_index(args.load_index)
    else:
        r.index_corpus(args.root_path, args.collection, args.visual_feature,
                       args.split)
    if args.save_index:
        r.save_index(args.save_index, prewarm=prewarm)
        if not args.queries:
            return
    max_desc_l = r.model.config.max_desc_l
    if args.queries.endswith((".hdf5", ".h5", ".npz")):
        cap_ids, feats, mask = _read_query_store(args.queries, max_desc_l)
    else:
        from dldkd_tpu_torch.data.ingest import dataset_paths, pack_query_set

        paths = dataset_paths(args.root_path, args.collection,
                              args.visual_feature)
        q = pack_query_set(args.queries, paths["text_feat"],
                           max_desc_l=max_desc_l)
        cap_ids, feats, mask = q.cap_ids, q.feats, q.mask

    results = r.search_ids(feats, mask, args.k)
    if mesh is not None and mesh.rank != 0:
        return   # every rank holds the same results; rank 0 writes them
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    for cap_id, topk in zip(cap_ids, results):
        out.write(json.dumps({"cap_id": cap_id, "topk": topk}) + "\n")
    if out is not sys.stdout:
        out.close()


if __name__ == "__main__":
    main()
