"""Online retrieval serving on one GPU: device-resident top-k search (port
of dldkd_tpu/serving.py, single device).

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

CLI: python -m dldkd_tpu_torch.serving --model_dir <run> --root_path <root>
        --collection tvr --visual_feature i3d_resnet --queries q.npz --k 10
writes one JSON line per query: {"cap_id", "topk": [[video_id, score], ...]}.

Not ported (each raises naming its ROADMAP item): save_index/load_index,
prewarm, the executable cache and warm start (A13); a device mesh (A14).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Tuple

import numpy as np
import torch

from dldkd_tpu_torch import checkpoint as ckpt_lib
from dldkd_tpu_torch import resolve_device
from dldkd_tpu_torch.convert import load_jax_params
from dldkd_tpu_torch.data.ingest import PackedVideos
from dldkd_tpu_torch.evaluate import (device_memory_budget, embed_corpus,
                                      embed_corpus_q8)
from dldkd_tpu_torch.models import DLDKD
from dldkd_tpu_torch.ops.fast_eval import (encode_context_best,
                                           encode_query_best, tower_dtype,
                                           tower_weights)
from dldkd_tpu_torch.ops.kernels.query_tower import quantize_frames_q8
from dldkd_tpu_torch.ops.kernels.sim_max import build_q8_index
from dldkd_tpu_torch.ops.masking import l2_normalize
from dldkd_tpu_torch.ops.similarity import (clip_scores_maxpool,
                                            clip_scores_maxpool_pre8,
                                            dense_rescore_wins,
                                            exact_clip_scores,
                                            rescore_shortlist)

SHORTLIST_FACTOR = 4  # default stage-1 candidates per result (k' = 4k)
# search keeps at most this many batches' results un-fetched: the oldest is
# forced to the host before the next batch uploads
_SEARCH_INFLIGHT_BATCHES = 8


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


def _search_q8(model, weights, q_feats, q_mask, q8_i, q8_e, q8_bias, k,
               frames_i, frames_e, vmask, fusion, rescore=True,
               shortlist_factor=SHORTLIST_FACTOR, plain=False):
    """score_quant search of one query batch against the prebuilt int8
    index: stage 1 straight on the index, then (rescore) stage 2 on the
    stored frames, or the raw int8 top k."""
    inher_q, explore_q = encode_query_best(model, q_feats, q_mask, weights,
                                           plain)
    s8 = _fuse(fusion, clip_scores_maxpool_pre8(inher_q, q8_i, q8_bias, plain),
               None if explore_q is None else clip_scores_maxpool_pre8(
                   explore_q, q8_e, q8_bias, plain))
    if rescore:
        return _rescore_stage2(s8, inher_q, explore_q, frames_i,
                               frames_e if explore_q is not None else None,
                               vmask, fusion, k, k, shortlist_factor, plain)
    return topk_lowest_index(s8, k)


def _search(model, weights, q_feats, q_mask, cn_inher, cn_explore, k, vmask,
            fusion, plain=False):
    """Exact search of one query batch against L2-normalized frames."""
    inher_q, explore_q = encode_query_best(model, q_feats, q_mask, weights,
                                           plain)
    scores = _fuse(fusion,
                   clip_scores_maxpool(inher_q, cn_inher, vmask,
                                       ctx_normalized=True, plain=plain),
                   None if explore_q is None else clip_scores_maxpool(
                       explore_q, cn_explore, vmask, ctx_normalized=True,
                       plain=plain))
    return topk_lowest_index(scores, k)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is ROADMAP {item}, not ported")


class Retriever:
    """Device-resident corpus index and batched top-k search on one GPU."""

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
        plain=True runs every kernel's plain PyTorch version instead, on
        any device: the reference side of a kernel check."""
        if mesh is not None:
            raise _not_ported("a device mesh (corpus-sharded serving)",
                              "A14")
        if index_store not in (None, "auto", "encoded", "raw"):
            raise ValueError(f"index_store: {index_store!r}")
        if warm_start:
            raise _not_ported("warm_start", "A13")
        if aot_cache_dir:
            raise _not_ported("the executable cache (aot_cache_dir)", "A13")
        self.device = resolve_device(device)
        self.model = model.eval()
        self.plain = bool(plain)
        self.weights = tower_weights(model, self.device)
        self.query_bsz = int(query_bsz)
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
        self.video_ids: List[str] = []

    def auto_index_store(self, n_videos: int) -> str:
        """'encoded' when the encoded index (frames in the tower dtype,
        plus the int8 index beside them when rescoring, or the int8 index
        alone without rescore) and its build transients fit the device's
        free memory, else 'raw'. A device that reports no budget (the
        CPU) keeps 'encoded'."""
        budget = device_memory_budget(self.device)
        if budget is None:
            return "encoded"
        mcfg = self.model.config
        itemsize = torch.tensor([], dtype=tower_dtype(mcfg)).element_size()
        if self.score_quant:
            itemsize = itemsize + 1 if self.rescore else 1
        hiddens = [mcfg.inheritance_hidden] + (
            [mcfg.exploration_hidden] if mcfg.double_branch else [])
        ctx = sum(n_videos * mcfg.max_ctx_l * h * itemsize for h in hiddens)
        need = 2 * ctx + 256 * 1024 * 1024
        return "encoded" if need <= budget else "raw"

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
        if store == "raw":
            n, sb = len(videos), self.stream_block
            n_pad = -(-n // sb) * sb
            self.raw_feats = torch.zeros(
                (n_pad,) + videos.feats.shape[1:],
                dtype=tower_dtype(self.model.config), device=self.device)
            self.raw_mask = torch.zeros((n_pad,) + videos.mask.shape[1:],
                                        dtype=torch.float32,
                                        device=self.device)
            # a block at a time: no corpus-sized f32 copy on the device
            for s in range(0, n, sb):
                block = torch.from_numpy(np.ascontiguousarray(
                    videos.feats[s:s + sb]))
                self.raw_feats[s:s + block.shape[0]].copy_(block)
            self.raw_mask[:n] = torch.from_numpy(
                np.asarray(videos.mask, np.float32))
            self.video_ids = list(videos.ids)
            return
        args = (self.model, videos, context_bsz, self.device, self.weights,
                self.plain)
        if self.score_quant and not self.rescore:
            self.q8_inher, self.q8_explore, self.q8_bias = \
                embed_corpus_q8(*args)
        else:
            ctx_i, ctx_e, self.vmask = embed_corpus(*args)
            if self.score_quant:
                # stage 2 reads the stored frames; stage 1 reads an int8
                # index built from them once, here
                self.ctx_inher, self.ctx_explore = ctx_i, ctx_e
                self.q8_inher, self.q8_bias = build_q8_index(
                    quantize_frames_q8(ctx_i, self.plain), self.vmask)
                if ctx_e is not None:
                    self.q8_explore = build_q8_index(
                        quantize_frames_q8(ctx_e, self.plain), self.vmask)[0]
            else:
                # the exact route normalizes its frames once, not per search
                self.ctx_inher = l2_normalize(ctx_i)
                self.ctx_explore = (l2_normalize(ctx_e) if ctx_e is not None
                                    else None)
        self.video_ids = list(videos.ids)

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

    def _search_batch(self, f: torch.Tensor, m: torch.Tensor, k: int):
        if self.q8_inher is not None:
            return _search_q8(self.model, self.weights, f, m, self.q8_inher,
                              self.q8_explore, self.q8_bias, k,
                              self.ctx_inher, self.ctx_explore, self.vmask,
                              self.fusion, self.rescore,
                              self.shortlist_factor, self.plain)
        return _search(self.model, self.weights, f, m, self.ctx_inher,
                       self.ctx_explore, k, self.vmask, self.fusion,
                       self.plain)

    def _query_batches(self, q_feats: np.ndarray, q_mask: np.ndarray):
        """The queries in serving batches on the device, each padded to
        query_bsz rows."""
        bsz = self.query_bsz
        for start in range(0, q_feats.shape[0], bsz):
            f = np.asarray(q_feats[start:start + bsz], np.float32)
            m = np.asarray(q_mask[start:start + bsz], np.float32)
            pad = bsz - f.shape[0]
            if pad:
                f = np.concatenate([f, np.zeros((pad,) + f.shape[1:],
                                                f.dtype)])
                m = np.concatenate([m, np.zeros((pad,) + m.shape[1:],
                                                m.dtype)])
            yield (torch.from_numpy(f).to(self.device),
                   torch.from_numpy(m).to(self.device))

    def _search_streaming(self, q_feats: np.ndarray, q_mask: np.ndarray,
                          k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Raw-store search (dldkd_tpu/serving.py:1065-1131, one device):
        encode all queries first, in serving batches with the same
        backpressure as the encoded store's search; then stream each raw
        corpus block once through the video towers (a bf16 block widened
        to f32, as the Pallas tower widens its input) and
        `_block_topk_core` against every query; merge the blocks' top k.
        One corpus pass per call, whatever the query count."""
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

    @torch.no_grad()
    def search(self, q_feats: np.ndarray, q_mask: np.ndarray, k: int = 10
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(scores (Nq, k) f32, indices (Nq, k)) over the indexed corpus.
        Queries are padded to the serving batch size internally."""
        if not self.video_ids:
            raise RuntimeError("call index()/index_corpus() first")
        k = min(k, len(self.video_ids))
        n = q_feats.shape[0]
        if self.index_store == "raw":
            scores, idx = self._search_streaming(q_feats, q_mask, k)
            return scores.cpu().numpy()[:n], idx.cpu().numpy()[:n]
        out: list = []
        for f, m in self._query_batches(q_feats, q_mask):
            # backpressure before this batch uploads: forcing the oldest
            # un-fetched result drains its batch, so at most
            # _SEARCH_INFLIGHT_BATCHES batches are pending on the device
            if len(out) >= _SEARCH_INFLIGHT_BATCHES:
                w = len(out) - _SEARCH_INFLIGHT_BATCHES
                out[w] = tuple(t.cpu() for t in out[w])
            out.append(self._search_batch(f, m, k))
        scores = torch.cat([s.cpu() for s, _ in out]).numpy()[:n]
        idx = torch.cat([i.cpu() for _, i in out]).numpy()[:n]
        return scores, idx

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
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model_dir", required=True)
    p.add_argument("--root_path", default="")
    p.add_argument("--collection", default="")
    p.add_argument("--visual_feature", default="")
    p.add_argument("--split", default="test")
    p.add_argument("--queries", default="",
                   help="feature store of cap_id -> (Lq, Dq) RoBERTa token "
                        "features (.hdf5, or its .npz twin), or a caption "
                        "file to look ids up in the standard TextData store")
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
    for flag, meta in (("--save_index", "DIR"), ("--load_index", "DIR"),
                       ("--prewarm", "LQ:K[,LQ:K...]"),
                       ("--aot_cache_dir", "DIR")):
        p.add_argument(flag, default="", metavar=meta,
                       help="ROADMAP A13, not ported")
    p.add_argument("--warm_start", action="store_true",
                   help="ROADMAP A13, not ported")
    args = p.parse_args(argv)
    for flag in ("save_index", "load_index", "prewarm", "aot_cache_dir",
                 "warm_start"):
        if getattr(args, flag):
            p.error(f"--{flag} is ROADMAP A13, not ported")
    if not args.queries:
        p.error("--queries is required (building an index artifact without "
                "queries, --save_index, is ROADMAP A13)")
    if not (args.root_path and args.collection and args.visual_feature):
        p.error("--root_path/--collection/--visual_feature are required to "
                "build the index")

    r = Retriever.from_checkpoint(args.model_dir,
                                  score_quant=args.score_quant,
                                  rescore=not args.no_rescore,
                                  shortlist_factor=args.shortlist_factor,
                                  index_store=args.index_store,
                                  stream_block=args.stream_block,
                                  device=args.torch_device)
    r.index_corpus(args.root_path, args.collection, args.visual_feature,
                   args.split)
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
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    for cap_id, topk in zip(cap_ids, results):
        out.write(json.dumps({"cap_id": cap_id, "topk": topk}) + "\n")
    if out is not sys.stdout:
        out.close()


if __name__ == "__main__":
    main()
