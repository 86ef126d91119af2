"""Per-stage eval throughput on the card at TVR serving scale (port of
dldkd_tpu/tools/stage_bench.py).

Times each stage of the serving eval separately (video towers, query
towers, per-branch scoring, ranking, and the int8 flow's stages) so that
kernel work can aim at the stage that costs. The workload is
`tools/workload.py`'s (bench.py's): 2,179 videos padded to 2,304, bf16 on
the card; 10,895 queries padded to 11,264, f32 on the 32-token grid; both
branches at hidden 384 in bf16; seeded random weights.

Each stage: one warm-up call, then `--reps` calls, each with its inputs
salted as the JAX tool salts them (+ 1e-4 * (k + 1), cast back to their
own dtype), and one device synchronize ends the window
(`workload.timed`). A video-tower stage widens the salted bf16 corpus to
f32 inside its window (the tower kernels take f32 input; the Pallas
kernels widen as they load). The towers read weights packed once
(`fast_eval.tower_weights`), as an eval does.

Rows, with the JAX tool's names:
- "(1 branch)" rows run a single-branch model holding the inheritance
  branch's weights, so each tower launch packs one branch (the one-branch
  Pallas kernels' counterpart, counted as query_tower_1br /
  context_tower_1br);
- the scoring rows score the towers' own outputs (`encode_*_best`); the
  queries come out of the bf16 towers in bf16, which selects the bf16
  scorer, as the JAX tool casts them (its precomputation through the XLA
  path works around a TPU compile helper and has no counterpart here);
- "q8 index build (transpose+bias, 1 br)" times the port's
  `build_q8_index`, which keeps the (Nv, L, H) layout and makes the bias
  (no transpose: the port's int8 scorer reads rows in that layout).

Prints each row to stderr, as the JAX tool logs them, and one JSON line of
the milliseconds to stdout. Runs on the card unless `--torch_device cpu`
(then the times are the CPU's).

Usage: python -m dldkd_tpu_torch.tools.stage_bench [--reps 10]
           [--n_videos N] [--n_queries N] [--torch_device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import torch

from dldkd_tpu_torch import resolve_device
from dldkd_tpu_torch.metrics import rank_of_gt
from dldkd_tpu_torch.ops.fast_eval import (encode_context_best,
                                           encode_context_q8,
                                           encode_query_best, tower_weights)
from dldkd_tpu_torch.ops.kernels.sim_max import build_q8_index
from dldkd_tpu_torch.ops.similarity import (clip_scores_maxpool,
                                            clip_scores_maxpool_pre8)
from dldkd_tpu_torch.tools import workload as wl

SUM_ROWS = ("ctx towers  (2 branches)", "query towers (2 branches)",
            "scoring (2 branches, int8) + rank")


def _salted(x: torch.Tensor, salt: float) -> torch.Tensor:
    """x + salt in x's own dtype (the JAX tool's `(x + salt).astype(...)`)."""
    return (x + salt).to(x.dtype)


@torch.no_grad()
def bench(reps: int = 10, n_videos: int = wl.N_VIDEOS,
          n_queries: int = wl.N_QUERIES, device=None) -> dict:
    dev = resolve_device(device)
    t0 = time.perf_counter()
    data = wl.serving_inputs(dev, n_videos, n_queries)
    vfeats, vmask, qfeats, qmask, gt = (data[k] for k in (
        "vfeats", "vmask", "qfeats", "qmask", "gt"))
    model = wl.serving_model(0, dev)
    one = wl.serving_model(device=dev, one_branch_of=model)
    ws = {True: tower_weights(model, dev), False: tower_weights(one, dev)}
    wl.sync(dev)
    wl.log(f"data gen + staging: {time.perf_counter() - t0:.1f}s")

    def ctx_stage(both):
        m = model if both else one

        def run(salt):
            ci, ce = encode_context_best(m, _salted(vfeats, salt).float(),
                                         vmask, ws[both])
            out = ci.float().sum()
            return out if ce is None else out + ce.float().sum()
        return run

    def qry_stage(both):
        m = model if both else one

        def run(salt):
            qi, qe = encode_query_best(m, qfeats + salt, qmask, ws[both])
            out = qi.float().sum()
            return out if qe is None else out + qe.float().sum()
        return run

    # the scoring stages' inputs, from the towers; the bf16 config's query
    # towers return bf16 vectors (the JAX tool's cast), so the bf16 scorer
    ctx_i, ctx_e = encode_context_best(model, vfeats.float(), vmask,
                                       ws[True])
    q_i, q_e = (q.to(torch.bfloat16) for q in encode_query_best(
        model, qfeats, qmask, ws[True]))

    def score_one(quant):
        return lambda salt: clip_scores_maxpool(
            _salted(q_i, salt), ctx_i, vmask, quantized=quant).sum()

    def score_both_rank(quant):
        def run(salt):
            fused = (0.7 * clip_scores_maxpool(_salted(q_i, salt), ctx_i,
                                               vmask, quantized=quant)
                     + 0.3 * clip_scores_maxpool(_salted(q_e, salt), ctx_e,
                                                 vmask, quantized=quant))
            return rank_of_gt(fused, gt)
        return run

    fused0 = (0.7 * clip_scores_maxpool(q_i, ctx_i, vmask)
              + 0.3 * clip_scores_maxpool(q_e, ctx_e, vmask))

    rows: Dict[str, float] = {}

    def row(name, fn):
        # fn(salt): call k of the protocol salts by 1e-4 * k
        rows[name] = wl.timed(lambda k: fn(1e-4 * k), reps,
                              dev).per_call_s * 1e3
        wl.log(f"{name:<42s} {rows[name]:8.2f} ms")

    wl.log(f"--- per-stage (reps={reps}, salted) ---")
    row("ctx towers  (1 branch)", ctx_stage(False))
    row("ctx towers  (2 branches)", ctx_stage(True))
    row("query towers (1 branch)", qry_stage(False))
    row("query towers (2 branches)", qry_stage(True))
    row("scoring (1 branch, bf16)", score_one(False))
    row("scoring (1 branch, int8)", score_one(True))
    row("scoring (2 branches, bf16) + rank", score_both_rank(False))
    row("scoring (2 branches, int8) + rank", score_both_rank(True))
    row("rank only", lambda salt: rank_of_gt(fused0 + salt, gt))
    total = sum(rows[k] for k in SUM_ROWS)
    wl.log(f"--- sum(ctx2 + qry2 + int8-score2+rank) = {total:.1f} ms "
           f"-> {n_queries / total * 1e3:.0f} q/s ---")

    # the int8 flow: the towers' int8 epilogue, the index build, scoring
    # on the prebuilt index
    q8_i0, q8_e0 = encode_context_q8(model, vfeats.float(), vmask, ws[True])
    t_i0, bias0 = build_q8_index(q8_i0, vmask)
    t_e0, _ = build_q8_index(q8_e0, vmask)

    def ctx_q8_stage(salt):
        q8_i, q8_e = encode_context_q8(model, _salted(vfeats, salt).float(),
                                       vmask, ws[True])
        return q8_i.int().sum() + q8_e.int().sum()

    def build_stage(salt):
        isalt = int(round(salt * 1e4))      # distinct int per rep
        t, bias = build_q8_index(q8_i0 + isalt, vmask)
        return t.int().sum() + bias.sum()

    def score_pre8_rank(salt):
        fused = (0.7 * clip_scores_maxpool_pre8(_salted(q_i, salt), t_i0,
                                                bias0)
                 + 0.3 * clip_scores_maxpool_pre8(_salted(q_e, salt), t_e0,
                                                  bias0))
        return rank_of_gt(fused, gt)

    wl.log("--- q8 flow ---")
    row("ctx towers q8-emit (2 branches)", ctx_q8_stage)
    row("q8 index build (transpose+bias, 1 br)", build_stage)
    row("scoring pre8 (2 branches) + rank", score_pre8_rank)
    total8 = (rows["ctx towers q8-emit (2 branches)"]
              + 2 * rows["q8 index build (transpose+bias, 1 br)"]
              + rows["query towers (2 branches)"]
              + rows["scoring pre8 (2 branches) + rank"])
    wl.log(f"--- q8 flow sum(ctx8 + 2*build + qry2 + pre8+rank) = "
           f"{total8:.1f} ms -> {n_queries / total8 * 1e3:.0f} q/s ---")
    return {"tool": "stage_bench", "device": wl.device_name(dev),
            "reps": reps, "videos": n_videos,
            "videos_padded": int(vfeats.shape[0]), "queries": n_queries,
            "queries_padded": int(qfeats.shape[0]), "stages_ms": rows,
            "sum_ms": total, "sum_queries_per_s": n_queries / total * 1e3,
            "q8_sum_ms": total8,
            "q8_sum_queries_per_s": n_queries / total8 * 1e3}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--n_videos", type=int, default=wl.N_VIDEOS)
    ap.add_argument("--n_queries", type=int, default=wl.N_QUERIES)
    ap.add_argument("--torch_device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    rec = bench(args.reps, args.n_videos, args.n_queries, args.torch_device)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
