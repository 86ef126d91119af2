"""The search loop: open-loop queries into the program's serving path,
`serving.Retriever.search`.

    python3 benchmark/run.py --workload activitynet.search --seed 7 \
        --seconds 30 --trace 0

Set-up makes the split and the weights from the seed
(`inputs.eval_inputs`, `inputs.weights`), builds the program's kernels,
makes `Retriever(model, query_bsz, device=cuda:0, index_store,
score_quant)` (the device named, so that no mesh is built on a machine
with several cards), indexes every video of the split, and warms up with
one search of 1 query and one of `query_bsz`. The query pool is the
split's queries in the order the generator draws them, which is the
seed's; arrival i asks pool row i mod n_queries, so a batch is a slice
of the host array (a view, copied only where the pool wraps).

Arrivals are Poisson at the mix's `rate_qps`: the gaps between them are
the exponential distribution's quantiles at N = rate x seconds evenly
spaced points, in the seed's order, scaled to fill the window exactly.
Every seed offers the same N queries with the same gaps, in another
order.

The dispatcher (the main thread) sends, whenever it is free, every
arrived query not yet sent, up to `query_bsz`, in one
`retriever.search(feats, masks, k)`, which returns with the results on
the host; with nothing due it sleeps until the next arrival. Nothing is
dropped: a dispatcher that falls behind builds a queue, and the latency
shows it. The window holds every query due in [t0, t0 + seconds) and
ends when the last of them has returned.

search_qps: the queries returned / (window end - t0).
search_p95_ms: the 95th percentile, over every query of the window, of
(its result on the host - its due time).

A traced run then traces `traced_calls` further dispatches at the same
rate, outside the window.

For `correct`, the warm single query (a batch of 255 padded rows and
one real one) and one search of the window, drawn from the seed, keep
their results; once the window has closed and the program is freed,
`reference/search_ref.py` recomputes those queries' fused scores over
every video and judges the returned top k. The control and the planted
fault are `control.py`'s `search_control` and `faults.py`'s
`alter_search_scores`.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import harness, inputs
from benchmark.cost import model_ops
from benchmark.loops import common
from benchmark.reference import search_ref

# the seed's streams: the arrivals' order, the warm query, the checked call
ARRIVALS, WARM, PICK = 1, 2, 3


def stream(seed: int, which: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**63, which])


def arrival_offsets(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Seconds from the window's start to each arrival: N = rate x
    seconds arrivals, the first at 0, all before `seconds`."""
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps = gaps[stream(seed, ARRIVALS).permutation(n)]
    gaps *= seconds / gaps.sum()
    return np.cumsum(gaps) - gaps


def top_k_of(cell: harness.Cell) -> int:
    """The length of each returned list: the mix's k, at most the
    corpus."""
    return min(int(cell.mix["k"]), int(cell.config["n_videos"]))


def least_seconds(cfg: dict, n_queries: int, k: int) -> float:
    """The least time the card could take for one search call."""
    w = model_ops.search_work(cfg, n_queries, k)
    return model_ops.least_seconds(w["flops"], w["bytes"])


def pool_rows(feats: np.ndarray, masks: np.ndarray, a: int, b: int):
    """Pool rows of arrivals [a, b): a view unless the pool wraps."""
    p = feats.shape[0]
    s = a % p
    if s + (b - a) <= p:
        return feats[s:s + b - a], masks[s:s + b - a]
    idx = np.arange(a, b) % p
    return feats[idx], masks[idx]


@dataclass
class Call:
    start: int            # the first arrival it carried
    stop: int             # one past its last
    done: float           # host time its results were on the host
    seconds: float        # its own host time
    scores: np.ndarray
    ids: np.ndarray


def _no_range(name: str):
    return contextlib.nullcontext()


def dispatch(search: Callable, feats: np.ndarray, masks: np.ndarray,
             due: np.ndarray, bsz: int, first: int = 0,
             max_calls: Optional[int] = None, traced: bool = False,
             clock=time.perf_counter, sleep=time.sleep) -> List[Call]:
    """Serve the arrivals due at the sorted host times `due` (arrival j
    asks pool row first + j) until all are answered, or after max_calls
    calls. `search(feats, masks)` returns (scores, ids) on the host. A
    traced dispatcher marks its calls and waits as profiler ranges."""
    mark = record_function if traced else _no_range
    calls: List[Call] = []
    n, sent = len(due), 0
    while sent < n and (max_calls is None or len(calls) < max_calls):
        now = clock()
        ready = int(np.searchsorted(due, now, side="right"))
        if ready <= sent:
            with mark("bench/wait"):
                sleep(due[sent] - now)
            continue
        stop = min(ready, sent + bsz)
        f, m = pool_rows(feats, masks, first + sent, first + stop)
        with mark("bench/search_call"):
            t = clock()
            scores, ids = search(f, m)
            done = clock()
        calls.append(Call(sent, stop, done, done - t, scores, ids))
        sent = stop
    return calls


def latencies(calls: List[Call], due: np.ndarray) -> np.ndarray:
    """Seconds from each answered arrival's due time to its result."""
    lat = np.full(len(due), np.nan)
    for c in calls:
        lat[c.start:c.stop] = c.done - due[c.start:c.stop]
    return lat


def window_stats(calls: List[Call], due: np.ndarray, t0: float,
                 seconds: float, bsz: int) -> Dict[str, float]:
    """The window's numbers: the two end-to-end metrics and what the
    knee's sweep reads (answered by the nominal end, the p95 of the
    first and last thirds of arrivals, batch sizes, queueing)."""
    lat = latencies(calls, due) * 1e3
    n = len(due)
    answered = int(np.isfinite(lat).sum())
    third = max(1, n // 3)
    sizes = np.array([c.stop - c.start for c in calls])
    # from the oldest query's due time to the start of the call that
    # carries it: how late the dispatcher ran
    waits = np.array([c.done - c.seconds - due[c.start] for c in calls])
    return {
        "offered": n, "answered": answered,
        "answered_by_end": int(sum(c.stop - c.start for c in calls
                                   if c.done <= t0 + seconds)),
        "window_s": calls[-1].done - t0,
        "search_qps": answered / (calls[-1].done - t0),
        "search_p95_ms": float(np.percentile(lat, 95)),
        "p50_ms": float(np.percentile(lat, 50)),
        "p99_ms": float(np.percentile(lat, 99)),
        "p95_first_third_ms": float(np.percentile(lat[:third], 95)),
        "p95_last_third_ms": float(np.percentile(lat[-third:], 95)),
        "calls": len(calls), "mean_batch": float(sizes.mean()),
        "full_batches": int((sizes == bsz).sum()),
        "call_ms": float(np.median([c.seconds for c in calls]) * 1e3),
        "queue_ms": float(np.median(waits) * 1e3),
    }


@dataclass
class Served:
    """What set-up leaves for the window: the program's retriever, the
    inputs and weights, and the warm single query's result."""

    retriever: object
    device: torch.device
    data: dict
    base: Dict[str, torch.Tensor]
    warm_row: int
    warm: tuple


def setup(cell: harness.Cell, seed: int, device: torch.device) -> Served:
    from dldkd_tpu_torch import serving
    from dldkd_tpu_torch.data.ingest import PackedVideos

    cfg, mix = cell.config, cell.mix
    if device.type == "cuda":
        from dldkd_tpu_torch.ops.kernels import build

        build.build()
        device = torch.device("cuda", device.index or 0)
    data = inputs.eval_inputs(cfg, mix, seed, device)
    base = inputs.weights(cfg, seed, device)
    model = common.port_model(cfg, base, device).eval()
    retriever = serving.Retriever(
        model, query_bsz=int(mix["query_bsz"]), device=device,
        index_store=mix["index_store"], score_quant=mix["score_quant"])
    retriever.index(PackedVideos(data["vfeats"], data["vmask"],
                                 inputs.ids("v", cfg["n_videos"])),
                    context_bsz=cfg["eval_context_bsz"])
    row = int(stream(seed, WARM).integers(cfg["n_queries"]))
    k = int(mix["k"])
    warm = retriever.search(data["qfeats"][row:row + 1],
                            data["qmask"][row:row + 1], k)
    retriever.search(*pool_rows(data["qfeats"], data["qmask"], 0,
                                int(mix["query_bsz"])), k)
    common.sync(device)
    return Served(retriever, device, data, base, row, warm)


def run(cell: harness.Cell, seed: int, seconds: float, traced: bool,
        device: torch.device, t_start: float) -> harness.Result:
    from dldkd_tpu_torch import float32_matmul_precision

    cfg, mix = cell.config, cell.mix
    bsz, k = int(mix["query_bsz"]), int(mix["k"])
    offsets = arrival_offsets(float(mix["rate_qps"]), seconds, seed)
    window = common.TracedWindow(device) if traced else None
    with float32_matmul_precision(cfg["matmul_precision"]):
        s = setup(cell, seed, device)
        retriever, feats, masks = s.retriever, s.data["qfeats"], \
            s.data["qmask"]

        def search(f, m):
            return retriever.search(f, m, k)

        setup_s = time.perf_counter() - t_start
        common.log(f"set-up {setup_s:.3f} s; {len(offsets)} arrivals at "
                   f"{mix['rate_qps']} queries/s")
        t0 = time.perf_counter()
        due = t0 + offsets
        calls = dispatch(search, feats, masks, due, bsz)
        stats = window_stats(calls, due, t0, seconds, bsz)
        traced_calls: List[Call] = []
        if window is not None:
            # the traced dispatches follow the window and are not in it
            window.start()
            traced_calls = dispatch(
                search, feats, masks, time.perf_counter() + offsets, bsz,
                first=len(offsets), max_calls=int(mix["traced_calls"]),
                traced=True)
            window.stop()
    common.log("window: " + " ".join(f"{n} {v:.6g}" for n, v in
                                    stats.items()))
    peak = common.memory_peak(s.device)
    nq = cfg["n_queries"]
    pick = calls[int(stream(seed, PICK).integers(len(calls)))]
    rows = np.concatenate([[s.warm_row],
                           np.arange(pick.start, pick.stop) % nq])
    scores = np.concatenate([s.warm[0], pick.scores])
    ids = np.concatenate([s.warm[1], pick.ids])
    data, base, dev = s.data, s.base, s.device
    del s, retriever, search
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    reference = search_ref.fused_scores(base, cfg, data, rows, dev)
    checks = search_ref.compare_search(scores, ids, reference,
                                       top_k_of(cell),
                                       cell.params["limits"]
                                       ["scores_abs_err"])
    common.log(f"checked call of {pick.stop - pick.start} queries and the "
               f"warm query; reference and comparison "
               f"{time.perf_counter() - t_ref:.3f} s")
    work = {"flops": sum(model_ops.search_work(cfg, c.stop - c.start, k)
                         ["flops"] for c in calls),
            "call_s": sum(c.seconds for c in calls),
            "traced_least_s": sum(least_seconds(cfg, c.stop - c.start, k)
                                  for c in traced_calls)}
    return harness.Result(
        attempted=stats["offered"],
        failed=stats["offered"] - stats["answered"],
        metrics={"search_qps": stats["search_qps"],
                 "search_p95_ms": stats["search_p95_ms"],
                 "setup_s": setup_s},
        checks=checks, window_s=stats["window_s"], units=len(calls),
        memory_peak_bytes=peak,
        extra={"traced_calls": len(traced_calls),
               "call_ms": stats["call_ms"]},
        trace=window.trace if window is not None else None, work=work)
