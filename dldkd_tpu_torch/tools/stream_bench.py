"""Corpus-streaming eval benchmark at a multiple of the TVR corpus (port of
dldkd_tpu/tools/stream_bench.py).

Two postures:

  hbm-raw   the raw bf16 corpus is the device-resident index (8x TVR:
            17,432 videos in 9 blocks of 2,048, 4.8 GB); each pass encodes
            every query (both towers), then each block through the video
            towers and the per-call int8 scorer (`clip_scores_maxpool(
            quantized=True)`), fuses 0.7 / 0.3, joins the blocks' columns
            block-major and ranks the ground truth: the encoded frames
            never exist beyond one block. Every pass salts the parameters
            and packs the towers' weights anew, as bench.py's programs add
            the salt to every parameter. One first pass, then `--reps`
            passes and one device synchronize: queries/s sustained.
  host      the f32 corpus stays in host memory (2.28 GB at 2x TVR) and
            `evaluate.run_retrieval_eval` streams it through the card in
            blocks of 2,048 with int8 scoring (`corpus_stream_bsz` 2,048,
            `eval_query_bsz` 512, `score_quant`; pinned staging buffers, a
            side stream): the seconds of one call, first use included
            (`--host`).

Prints one JSON line with the JAX tool's keys: metric, unit, value (the
hbm-raw queries/s), detail, and host_stream under `--host`. Runs on the
card unless `--torch_device cpu` (then the times are the CPU's).

Usage: python -m dldkd_tpu_torch.tools.stream_bench [--scale 8] [--host]
           [--reps 5] [--n_videos N] [--n_queries N] [--host_queries N]
           [--torch_device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Sequence

import numpy as np
import torch

from dldkd_tpu_torch import resolve_device
from dldkd_tpu_torch.data.ingest import PackedQueries, PackedVideos
from dldkd_tpu_torch.config import EvalConfig
from dldkd_tpu_torch.evaluate import run_retrieval_eval
from dldkd_tpu_torch.metrics import rank_of_gt
from dldkd_tpu_torch.ops.fast_eval import (encode_context_best,
                                           encode_query_best)
from dldkd_tpu_torch.ops.similarity import clip_scores_maxpool
from dldkd_tpu_torch.tools import workload as wl

BLOCK = 2048  # videos per streamed block


@torch.no_grad()
def streaming_scores(model, weights, vblocks: Sequence[torch.Tensor],
                     mblocks: Sequence[torch.Tensor], qfeats: torch.Tensor,
                     qmask: torch.Tensor, plain: bool = False
                     ) -> torch.Tensor:
    """Fused 0.7 / 0.3 int8 scores (Nq, n_blocks * block) of every query
    against each corpus block, encoded on the fly, columns block-major
    (dldkd_tpu/tools/stream_bench.py:81-98). A bf16 block is widened to
    f32 for the towers. plain=True runs every kernel's plain version."""
    qi, qe = encode_query_best(model, qfeats, qmask, weights, plain)
    cols = []
    for bf, bm in zip(vblocks, mblocks):
        ci, ce = encode_context_best(model, bf.float(), bm, weights, plain)
        cols.append(0.7 * clip_scores_maxpool(qi, ci, bm, plain=plain,
                                              quantized=True)
                    + 0.3 * clip_scores_maxpool(qe, ce, bm, plain=plain,
                                                quantized=True))
        del ci, ce   # one encoded block alive at a time
    return torch.cat(cols, dim=1)


def bench_hbm_raw(scale: int, reps: int = 5, n_videos: int = wl.N_VIDEOS,
                  n_queries: int = wl.N_QUERIES, device=None) -> dict:
    dev = resolve_device(device)
    model = wl.serving_model(0, dev)
    salted = wl.SaltedWeights(model, dev)
    n_vid = n_videos * scale
    block = BLOCK
    t0 = time.perf_counter()
    data = wl.serving_inputs(dev, n_vid, n_queries, video_grid=block)
    n_blocks = data["vfeats"].shape[0] // block
    vblocks = data["vfeats"].view(n_blocks, block, wl.L_FRAMES, wl.D_STUDENT)
    mblocks = data["vmask"].view(n_blocks, block, wl.L_FRAMES)
    qfeats, qmask, gt = data["qfeats"], data["qmask"], data["gt"]
    wl.sync(dev)
    wl.log(f"on-device corpus: {vblocks.nbytes / 1e9:.2f} GB raw bf16 "
           f"({n_vid} videos = {scale} x {n_videos}), gen "
           f"{time.perf_counter() - t0:.1f}s")

    def one_pass(k):
        return rank_of_gt(streaming_scores(model, salted(1e-4 * k), vblocks,
                                           mblocks, qfeats, qmask), gt)

    t = wl.timed(one_pass, reps, dev)
    wl.log(f"first run: {t.first_s:.1f}s")
    dt = t.per_call_s
    ranks = t.last.cpu().numpy()[:n_queries]
    sumr = sum(100.0 * (ranks <= k).mean() for k in (1, 5, 10, 100))
    qps = n_queries / dt
    wl.log(f"hbm-raw streaming eval at {scale} x {n_videos} videos: "
           f"{dt:.3f}s/pass -> {qps:.0f} queries/sec sustained "
           f"(random-data sumr {sumr:.1f})")
    return {"qps": qps, "seconds_per_pass": dt, "videos": n_vid,
            "scale": scale}


def bench_host_stream(scale: int, n_videos: int = wl.N_VIDEOS,
                      n_queries: int = 2048, device=None) -> dict:
    """The f32 corpus in host memory, streamed through the card by
    run_retrieval_eval's streaming route (int8 scoring): seconds of one
    call."""
    dev = resolve_device(device)
    model = wl.serving_model(0, dev)
    n_vid = n_videos * scale
    rng = np.random.RandomState(0)
    videos = PackedVideos(
        feats=rng.rand(n_vid, wl.L_FRAMES, wl.D_STUDENT).astype(np.float32),
        mask=np.ones((n_vid, wl.L_FRAMES), np.float32),
        ids=[f"v{i}" for i in range(n_vid)])
    gt_ids = [videos.ids[i % n_vid] for i in range(n_queries)]
    queries = PackedQueries(
        feats=rng.rand(n_queries, wl.L_TOK_PAD, wl.D_QUERY).astype(
            np.float32),
        mask=np.tile((np.arange(wl.L_TOK_PAD) < wl.L_TOKENS
                      ).astype(np.float32), (n_queries, 1)),
        cap_ids=[f"{v}#enc#{i}" for i, v in enumerate(gt_ids)],
        video_ids=gt_ids)
    wl.log(f"host corpus: {videos.feats.nbytes / 1e9:.2f} GB f32 "
           f"({n_vid} videos = {scale} x {n_videos})")
    t0 = time.perf_counter()
    cfg = EvalConfig(eval_query_bsz=512, score_quant=True,
                     corpus_stream_bsz=BLOCK)
    out = run_retrieval_eval(model, videos, queries, cfg, device=dev)
    wl.sync(dev)
    dt = time.perf_counter() - t0
    wl.log(f"host streaming eval: {dt:.2f}s for {n_queries} queries x "
           f"{n_vid} videos (sumr {out['fused']['sumr']:.1f})")
    return {"seconds": dt, "videos": n_vid, "queries": n_queries}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=8,
                    help="corpus scale in multiples of the TVR test corpus")
    ap.add_argument("--host", action="store_true",
                    help="also run the host-to-device streaming posture")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--n_videos", type=int, default=wl.N_VIDEOS,
                    help="the corpus that --scale multiplies")
    ap.add_argument("--n_queries", type=int, default=wl.N_QUERIES)
    ap.add_argument("--host_queries", type=int, default=2048)
    ap.add_argument("--torch_device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    out = {"metric": "streaming_eval_throughput", "unit": "queries/sec"}
    hbm = bench_hbm_raw(args.scale, args.reps, args.n_videos, args.n_queries,
                        args.torch_device)
    out.update(value=hbm["qps"], detail=hbm)
    if args.host:
        out["host_stream"] = bench_host_stream(
            max(2, args.scale // 4), args.n_videos, args.host_queries,
            args.torch_device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
