"""Serving search latency on the card at TVR corpus scale (port of
dldkd_tpu/tools/search_bench.py).

Times the serving search functions of one query batch directly on
device-resident inputs: 20 reps of 256-query batches, k = 10, both
branches, bf16 frames (`tools/workload.py`'s workload, 2,179 videos padded
to 2,304). The index is built once, outside the timings. Each row: one
first call, then the reps, one device synchronize, ms per batch:

  exact        `serving._search`: bf16 scoring of every video + top k,
               against frames L2-normalized once (as `Retriever.index`
               stores them for the exact route)
  two_stage    `serving._two_stage_topk` after the query towers: the
               per-call int8 quantization of the frames + int8 shortlist +
               exact rescore (dense or gather stage 2, as
               `dense_rescore_wins` picks)
  two_stage_q8 `serving._search_q8` on the prebuilt int8 index, rescored
  int8_only_q8 the same without rescore (the int8 ranks)

Prints one JSON line {row: ms per batch}. `--ids_out F` also writes the
exact row's ids of the first batch to F (.npy), which `chip_smoke.py`
holds against `Retriever.search` on the same batch. Runs on the card
unless `--torch_device cpu`.

Usage: python -m dldkd_tpu_torch.tools.search_bench [--reps 20]
           [--n_queries 256] [--n_videos N] [--ids_out F]
           [--torch_device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from dldkd_tpu_torch import resolve_device
from dldkd_tpu_torch.ops.fast_eval import (encode_context_best,
                                           encode_context_q8,
                                           encode_query_best, tower_weights)
from dldkd_tpu_torch.ops.kernels.sim_max import build_q8_index
from dldkd_tpu_torch.ops.masking import l2_normalize
from dldkd_tpu_torch.serving import _search, _search_q8, _two_stage_topk
from dldkd_tpu_torch.tools import workload as wl

ROWS = ("exact", "two_stage", "two_stage_q8", "int8_only_q8")
K = 10   # results per query


def search_inputs(dev: torch.device, n_videos: int, reps: int,
                  n_queries: int) -> dict:
    """The corpus of `workload.serving_inputs` and `reps` batches of
    `n_queries` queries, (reps, n_queries, L_TOK_PAD, D_QUERY)."""
    data = wl.serving_inputs(dev, n_videos, reps * n_queries, query_grid=1)
    shape = (reps, n_queries)
    data["qfeats"] = data["qfeats"].view(*shape, wl.L_TOK_PAD, wl.D_QUERY)
    data["qmask"] = data["qmask"].view(*shape, wl.L_TOK_PAD)
    return data


@torch.no_grad()
def bench(reps: int = 20, n_queries: int = 256, n_videos: int = wl.N_VIDEOS,
          device=None, ids_out=None) -> dict:
    dev = resolve_device(device)
    model = wl.serving_model(0, dev)
    ws = tower_weights(model, dev)
    data = search_inputs(dev, n_videos, reps, n_queries)
    vmask, qfeats, qmask = data["vmask"], data["qfeats"], data["qmask"]

    # index build (once; not in the per-search timings)
    t0 = time.perf_counter()
    frames = data["vfeats"].float()
    ctx_i, ctx_e = encode_context_best(model, frames, vmask, ws)
    q8 = encode_context_q8(model, frames, vmask, ws)
    del frames
    q8_i, bias = build_q8_index(q8[0], vmask)
    q8_e, _ = build_q8_index(q8[1], vmask)
    cn_i, cn_e = l2_normalize(ctx_i), l2_normalize(ctx_e)
    wl.sync(dev)
    wl.log(f"index build (frames + q8): {time.perf_counter() - t0:.1f}s")
    # the Retriever's f32 fusion weights
    fusion = tuple(float(np.float32(w)) for w in (0.7, 0.3))

    def two_stage(r):
        qi, qe = encode_query_best(model, qfeats[r], qmask[r], ws)
        return _two_stage_topk(qi, qe, ctx_i, ctx_e, vmask, fusion, K, K)

    calls = {
        "exact": lambda r: _search(model, ws, qfeats[r], qmask[r], cn_i,
                                   cn_e, K, vmask, fusion),
        "two_stage": two_stage,
        "two_stage_q8": lambda r: _search_q8(
            model, ws, qfeats[r], qmask[r], q8_i, q8_e, bias, K, ctx_i,
            ctx_e, vmask, fusion, True),
        "int8_only_q8": lambda r: _search_q8(
            model, ws, qfeats[r], qmask[r], q8_i, q8_e, bias, K, None, None,
            vmask, fusion, False)}
    out = {}
    for label in ROWS:
        # the first call and call 1 search batch 0, call c batch c - 1
        t = wl.timed(lambda c, call=calls[label]: call(max(c - 1, 0)), reps,
                     dev)
        wl.log(f"[{label}] first: {t.first_s:.2f}s")
        if label == "exact" and ids_out:
            np.save(ids_out, t.first[1].cpu().numpy())
        out[label] = t.per_call_s * 1e3
        wl.log(f"[{label}] {out[label]:.3f} ms/batch ({n_queries} queries, "
               f"k={K})")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--n_queries", type=int, default=256,
                    help="queries per batch")
    ap.add_argument("--n_videos", type=int, default=wl.N_VIDEOS)
    ap.add_argument("--ids_out", default=None,
                    help="write the exact row's first-batch ids here (.npy)")
    ap.add_argument("--torch_device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    out = bench(args.reps, args.n_queries, args.n_videos, args.torch_device,
                args.ids_out)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
