"""The knee of a search cell: one set-up, then a window at each offered
rate, on the card.

    python3 benchmark/sweep.py --workload activitynet.search --seed 7 \
        --rates 8000,12000,16000 --seconds 30

Prints one JSON line per rate with `loops/search.window_stats`' numbers.
A rate is sustained when the queries answered by the window's nominal
end are at least 99 % of those offered, the p95 latency of the last
third of arrivals is within 1.5 x that of the first third (the queue is
not growing), and the p95 is within 3 x the median call (no queue
builds at all: a query waits at most for the call in flight and its
own). A seed's knee is the highest rate below its first rate that is
not sustained; the sweep stops after two such rates in a row. Run it on
three seeds or more: the cell's knee is the median of theirs, and its
mix takes a rate below it as a number. The benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.loops import search  # noqa: E402


def sustained(stats: dict) -> bool:
    return (stats["answered_by_end"] >= 0.99 * stats["offered"]
            and stats["p95_last_third_ms"]
            <= 1.5 * stats["p95_first_third_ms"]
            and stats["search_p95_ms"] <= 3.0 * stats["call_ms"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    args = p.parse_args(argv)
    from dldkd_tpu_torch import float32_matmul_precision

    cell = harness.load_cell(args.workload)
    bsz, k = int(cell.mix["query_bsz"]), int(cell.mix["k"])
    with float32_matmul_precision(cell.config["matmul_precision"]):
        s = search.setup(cell, args.seed, torch.device("cuda"))
        feats, masks = s.data["qfeats"], s.data["qmask"]
        first, missed = 0, 0
        for rate in [float(r) for r in args.rates.split(",")]:
            offsets = search.arrival_offsets(rate, args.seconds, args.seed)
            t0 = time.perf_counter()
            due = t0 + offsets
            calls = search.dispatch(
                lambda f, m: s.retriever.search(f, m, k), feats, masks, due,
                bsz, first=first)
            first += len(offsets)
            stats = search.window_stats(calls, due, t0, args.seconds, bsz)
            ok = sustained(stats)
            print(json.dumps(dict(rate_qps=rate, sustained=ok, **stats)),
                  flush=True)
            missed = 0 if ok else missed + 1
            if missed == 2:
                break
    return 0


if __name__ == "__main__":
    sys.exit(main())
