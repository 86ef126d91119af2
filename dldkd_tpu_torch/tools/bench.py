"""The port's benchmark: one JSON line with the root bench.py's keys,
measured on the card (port of bench.py:70-731, without the reference
baseline).

  python -m dldkd_tpu_torch.tools.bench [--torch_device cuda|cpu]

Eval (`t2v_retrieval_throughput`, the headline, and `exact_bf16`): the TVR
serving workload of `tools/workload.py` (2,179 videos padded to 2,304,
bf16 on the card; 10,895 queries padded to 11,264, f32 on the 32-token
grid; seeded weights), every input on the card before timing. One call is
a full eval: the salted weights packed for the towers (bench.py adds the
salt to every parameter inside its program; here every parameter is set to
its value + salt and the towers' operands are packed anew, as an eval
packs them once), the video towers, the query towers, scoring of every
query against every video, the fused 0.7 / 0.3 scores and the ground
truth's ranks. The int8 route (bench.py:134-147): the video towers with
the int8 epilogue, `build_q8_index` per branch, the query towers,
`clip_scores_maxpool_pre8` per branch; the exact route (bench.py:180-191):
the video towers, bf16 scoring. One first call, then the best of 3 blocks
of 10 calls, one synchronize per block; queries/s = 10,895 / seconds per
call; the random-data SumR is logged.

Training (`train`, `train_bf16`, `train_bf16_stacked`): `train.train_step`
on `tools/train_bench.py`'s workload (bench.py's: 128 videos, 256
captions, do_tvr.sh's widths), f32 at matmul precision "highest", bf16 at
"default", bf16 with stacked towers: one first step, then 30 steps ended
by a read of the last loss: steps/s. `train_speed` is null: its
configuration is the TPU's hardware RNG (`--rng_impl rbg`), which means
nothing in the port, and timing the same step again under that name would
mislead. `train_scan` is the device-bound rate, 1000 / the device-busy ms
per step that `train_bench.profile_step` reads from torch.profiler; the
JAX key times 30 steps as one `lax.scan` program, which has no PyTorch
counterpart.

`coldstart_fleet`: `python -m dldkd_tpu_torch.tools.coldstart_bench
--policy fleet --replicas 2 --n_videos 545` in a subprocess (bench.py:
565-608). `streaming_8x`: `tools/stream_bench.bench_hbm_raw(8, reps=4)`.

`vs_baseline` is null throughout: bench.py's baseline is the reference
implementation's own eval and train step on torch-CPU (bench.py:444-562),
which needs the reference's source tree, not in this repository; no TPU
figure stands in for it. A part that fails raises, and the process exits
non-zero: no part's failure is written into the line. `device` is the
card's name and power limit as nvidia-smi prints them. The count options
(videos, queries, reps, steps, scale) exist to run the line small on the
CPU, together with smaller constants (the pads of `tools/workload.py`,
`stream_bench.BLOCK`, `train_bench.WORKLOAD`); the widths are always the
published ones. On the CPU the device-bound rates are null.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from typing import Dict, Tuple

import torch

from dldkd_tpu_torch import float32_matmul_precision, resolve_device
from dldkd_tpu_torch.metrics import rank_of_gt
from dldkd_tpu_torch.ops.fast_eval import (encode_context_best,
                                           encode_context_q8,
                                           encode_query_best)
from dldkd_tpu_torch.ops.kernels.sim_max import build_q8_index
from dldkd_tpu_torch.ops.similarity import (clip_scores_maxpool,
                                            clip_scores_maxpool_pre8)
from dldkd_tpu_torch.tools import stream_bench, train_bench
from dldkd_tpu_torch.tools import workload as wl

# bench.py's JSON keys (bench.py:674-731), which the line carries
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "note",
              "host_cpu_cores", "exact_bf16", "train", "train_bf16",
              "train_bf16_stacked", "train_speed", "train_scan",
              "coldstart_fleet", "streaming_8x")
ROUTES = (("int8", "int8"), ("exact_bf16", "exact"))
FUSION = (0.7, 0.3)
# (key, dtype, stacked, config) of the train keys
TRAIN_KEYS = (
    ("train", "float32", False, "f32 parity (matmul highest)"),
    ("train_bf16", "bfloat16", False,
     "bf16 towers, f32 losses (--dtype bfloat16)"),
    ("train_bf16_stacked", "bfloat16", True,
     "bf16 + both branches as one stacked computation (--stacked_towers)"))
TRAIN_SPEED_REASON = (
    "not measured: bench.py's train_speed is bf16 + stacked towers + the "
    "TPU's hardware RNG (--rng_impl rbg); the port draws every dropout "
    "mask from one torch.Generator and accepts --rng_impl without effect, "
    "so this configuration is train_bf16_stacked's")
TRAIN_SCAN_CONFIG = (
    "1000 / device-busy ms per train_step (the union of kernel, memcpy and "
    "memset spans in torch.profiler over 3 steps, "
    "tools/train_bench.profile_step): the device-bound rate, no host time "
    "between launches; bench.py times 30 steps as one lax.scan program, "
    "which has no PyTorch counterpart. f32_parity: the train setting; "
    "speed_stack: train_bf16_stacked")


@torch.no_grad()
def full_eval_scores(route: str, model, weights, vfeats: torch.Tensor,
                     vmask: torch.Tensor, qfeats: torch.Tensor,
                     qmask: torch.Tensor, plain: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-branch scores (Nq, Nv) of one full eval. route "int8": the video
    towers' int8 epilogue, the prebuilt index per branch, int8 scoring
    (bench.py:157-167); "exact": the video towers, masked-cosine scoring
    in the towers' dtype (bench.py:191-204). The corpus is widened to f32
    for the towers. plain=True runs every kernel's plain version."""
    frames = vfeats.float()
    if route == "int8":
        q8_i, q8_e = encode_context_q8(model, frames, vmask, weights, plain)
        del frames
        t_i, bias = build_q8_index(q8_i, vmask)
        t_e, _ = build_q8_index(q8_e, vmask)
        qi, qe = encode_query_best(model, qfeats, qmask, weights, plain)
        return (clip_scores_maxpool_pre8(qi, t_i, bias, plain),
                clip_scores_maxpool_pre8(qe, t_e, bias, plain))
    if route != "exact":
        raise ValueError(f"route: {route!r}")
    ci, ce = encode_context_best(model, frames, vmask, weights, plain)
    del frames
    qi, qe = encode_query_best(model, qfeats, qmask, weights, plain)
    return (clip_scores_maxpool(qi, ci, vmask, plain=plain),
            clip_scores_maxpool(qe, ce, vmask, plain=plain))


def full_eval(route: str, model, weights, data: Dict[str, torch.Tensor]
              ) -> torch.Tensor:
    """Ranks (Nq,) of the ground truth under the fused scores."""
    s_i, s_e = full_eval_scores(route, model, weights, data["vfeats"],
                                data["vmask"], data["qfeats"], data["qmask"])
    return rank_of_gt(FUSION[0] * s_i + FUSION[1] * s_e, data["gt"])


def bench_eval(n_videos: int = wl.N_VIDEOS, n_queries: int = wl.N_QUERIES,
               reps: int = 10, blocks: int = 3, device=None) -> dict:
    """{route label: {"qps", "seconds_per_eval", "first_s", "sumr"}}."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    data = wl.serving_inputs(dev, n_videos, n_queries)
    model = wl.serving_model(0, dev)
    salted = wl.SaltedWeights(model, dev)
    wl.sync(dev)
    wl.log(f"inputs on {wl.device_name(dev)}: {time.perf_counter() - t0:.1f}s"
           f" ({(data['vfeats'].nbytes + data['qfeats'].nbytes) / 1e9:.2f} "
           f"GB)")
    out = {}
    for label, route in ROUTES:
        t = wl.timed(lambda k, route=route: full_eval(
            route, model, salted(1e-4 * k), data), reps, dev, blocks)
        first, dt = t.first_s, t.per_call_s
        wl.log(f"[{label}] first run: {first:.2f}s")
        ranks = t.last.cpu().numpy()[:n_queries]
        sumr = float(sum(100.0 * (ranks <= k).mean() for k in (1, 5, 10,
                                                                 100)))
        out[label] = {"qps": n_queries / dt, "seconds_per_eval": dt,
                      "first_s": first, "sumr": sumr}
        wl.log(f"[{label}] full eval (embed+score+rank, fused 2-branch): "
               f"{dt * 1e3:.2f} ms -> {n_queries / dt:.0f} queries/sec "
               f"(random-data sumr {sumr:.1f})")
    salted(0.0)
    return out


def bench_train(dtype: str, stacked: bool, n_steps: int = 30,
                device=None) -> dict:
    """steps/s of train.train_step on the train bench's workload
    (`train_bench.WORKLOAD`), and on the card the device-busy ms per
    step."""
    dev = resolve_device(device)
    precision = train_bench.default_precision(dtype)
    w = train_bench.WORKLOAD
    tag = f"{dtype}{'+stacked' if stacked else ''}"
    with float32_matmul_precision(precision):
        st = train_bench.Setup(dtype, stacked, precision, dev, w)
        t0 = time.perf_counter()
        first = float(st.step()["loss_overall"])
        wl.log(f"[{tag}] first step: {time.perf_counter() - t0:.2f}s "
               f"(loss {first:.3f})")
        t0 = time.perf_counter()
        for _ in range(n_steps):
            losses = st.step()
        final = float(losses["loss_overall"])   # waits for the queue
        dt = (time.perf_counter() - t0) / n_steps
        if not math.isfinite(final):
            raise RuntimeError(f"[{tag}] non-finite loss {final}")
        prof = (train_bench.profile_step(st.step, train_bench.PROFILE_STEPS)
                if dev.type == "cuda" else None)
    busy = prof["device_busy_ms_per_step"] if prof else None
    wl.log(f"[{tag}] train step (bsz {w['bsz']}): {dt * 1e3:.2f} ms -> "
           f"{1.0 / dt:.2f} steps/sec (final loss {final:.3f}; device busy "
           f"{busy} ms)")
    return {"steps_per_s": 1.0 / dt, "ms_per_step": dt * 1e3,
            "device_busy_ms_per_step": busy,
            "kernels_per_step": prof["kernels_per_step"] if prof else None}


def bench_coldstart_fleet(replicas: int = 2, n_videos: int = 545,
                          device: str = "cuda") -> dict:
    """The replica cold start drill in subprocesses (coldstart_bench
    --policy fleet): p50 / p95 process start to first result, the slowest
    first search. Raises when the drill fails or any process errs."""
    proc = subprocess.run(
        [sys.executable, "-m", "dldkd_tpu_torch.tools.coldstart_bench",
         "--policy", "fleet", "--replicas", str(replicas),
         "--n_videos", str(n_videos), "--torch_device", str(device)],
        capture_output=True, text=True,
        # the drill budgets 1200 s per process (populate + replicas)
        timeout=(1 + replicas) * 1200 + 300, cwd=wl.REPO_ROOT)
    if proc.returncode:
        raise RuntimeError(f"fleet drill failed: {proc.stderr[-300:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    if "errors" in res or res.get("p50_first_result_s") is None:
        raise RuntimeError(f"fleet drill: {json.dumps(res)[:600]}")
    return {"p50_first_result_s": res["p50_first_result_s"],
            "p95_first_result_s": res["p95_first_result_s"],
            "max_first_search_s": max(r["first_search_s"]
                                      for r in res["replicas"]),
            "first_result_s": [r["first_result_s"] for r in res["replicas"]],
            "replicas": replicas, "n_videos": n_videos,
            "unit": "sec (process start -> first search result)",
            "config": "prewarmed index artifact + shared kernel-library "
                      "directory (tools/coldstart_bench --policy fleet)"}


def bench_streaming(scale: int = 8, reps: int = 4, **kw) -> dict:
    """`stream_bench.bench_hbm_raw`: queries/s at `scale` x the corpus."""
    res = stream_bench.bench_hbm_raw(scale, reps=reps, **kw)
    return {"value": res["qps"], "unit": "queries/sec",
            "videos": res["videos"], "scale": res["scale"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--torch_device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--n_videos", type=int, default=wl.N_VIDEOS,
                    help="the eval's corpus; streaming runs --stream_scale "
                         "times it")
    ap.add_argument("--n_queries", type=int, default=wl.N_QUERIES)
    ap.add_argument("--reps", type=int, default=10,
                    help="eval calls per timed block (3 blocks)")
    ap.add_argument("--train_steps", type=int, default=30)
    ap.add_argument("--stream_scale", type=int, default=8)
    ap.add_argument("--stream_reps", type=int, default=4)
    args = ap.parse_args(argv)
    dev = resolve_device(args.torch_device)
    cuda = dev.type == "cuda"

    ev = bench_eval(args.n_videos, args.n_queries, args.reps, device=dev)
    train = {key: bench_train(dtype, stacked, args.train_steps, dev)
             for key, dtype, stacked, _ in TRAIN_KEYS}
    fleet = bench_coldstart_fleet(device=dev.type)
    stream = bench_streaming(args.stream_scale, args.stream_reps,
                             n_videos=args.n_videos,
                             n_queries=args.n_queries, device=dev)

    def train_key(key, config):
        return {"metric": "train_step_throughput",
                "value": train[key]["steps_per_s"], "unit": "steps/sec",
                "vs_baseline": None, "config": config}

    def device_bound(key):
        busy = train[key]["device_busy_ms_per_step"]
        return 1e3 / busy if busy else None

    line = {
        "metric": "t2v_retrieval_throughput",
        "value": ev["int8"]["qps"],
        "unit": "queries/sec",
        "vs_baseline": None,
        "note": "serving (int8 scoring); vs_baseline null: the "
                "reference's torch-CPU baseline needs the reference "
                "implementation's source tree",
        "host_cpu_cores": os.cpu_count() or 1,
        "device": (wl.card() or wl.device_name(dev)) if cuda else "cpu",
        "exact_bf16": {"value": ev["exact_bf16"]["qps"],
                       "vs_baseline": None},
        **{key: train_key(key, config) for key, _, _, config in TRAIN_KEYS},
        "train_speed": {"metric": "train_step_throughput", "value": None,
                        "unit": "steps/sec", "vs_baseline": None,
                        "reason": TRAIN_SPEED_REASON},
        "train_scan": {"metric": "train_step_throughput_device_bound",
                       "unit": "steps/sec",
                       "f32_parity": device_bound("train"),
                       "speed_stack": device_bound("train_bf16_stacked"),
                       "config": TRAIN_SCAN_CONFIG},
        "coldstart_fleet": fleet,
        "streaming_8x": stream,
        "eval_detail": ev,
        "train_detail": train,
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
