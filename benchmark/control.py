"""Readings behind the limits of `correct`: the program's numbers over many
seeds (its lower readings) and the control's (its upper readings), on
the card at the cell's own size, in one process.

The control is the reference put in the program's place and computed in
the nearest precision below the configuration's float32: TF32 products
(TF32 on, where the reference runs with it off). Its outputs go through
the same comparison as the program's.

    python3 benchmark/control.py --workload activitynet.eval \
        --program-seeds 11,12,13 --control-seeds 21,22,23 --seconds 3
    python3 benchmark/control.py --workload activitynet.search \
        --program-seeds 31,32,33 --fault alter_search_scores --seconds 3

Prints one JSON line per seed: {"side", "seed", "checks"}. With
`--fault NAME` the program's seeds run with that fault (`faults.py`)
planted: a fault's readings at the cell's size. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from benchmark import faults, harness, inputs  # noqa: E402
from benchmark.reference import eval_ref, train_ref  # noqa: E402


def eval_control(cell: harness.Cell, seed: int, device) -> dict:
    cfg = cell.config
    data = inputs.eval_inputs(cfg, cell.mix, seed, device)
    base = inputs.weights(cfg, seed, device)
    exact = eval_ref.reference_eval(base, cfg, data, device,
                                    cfg["eval_context_bsz"])
    low = eval_ref.reference_eval(base, cfg, data, device,
                                  cfg["eval_context_bsz"], exact=False)
    names = {"inheritance": "inher", "exploration": "explore",
             "fused": "fused"}
    prog = {part: {names[k]: v for k, v in low[part].items()}
            for part in ("frames", "queries", "scores", "ranks")}
    prog["metrics"] = {names[k]: eval_ref.metrics_from_ranks(
        r.cpu().numpy()) for k, r in low["ranks"].items()}
    return eval_ref.compare_eval(prog, exact, data["gt"], data["vmask"],
                                 cell.params["limits"]["scores_abs_err"])


def train_control(cell: harness.Cell, seed: int, device) -> dict:
    from benchmark.loops import train as train_loop

    cfg = dict(cell.config, t_total=train_loop.t_total(cell.config),
               use_hard_negative=cell.config["hard_negative_start_epoch"]
               == 0)
    data = inputs.train_inputs(cfg, cell.mix, seed, device)
    base = inputs.weights(cfg, seed, device)
    loader_seed, gen_seed = train_loop.seeds(seed)
    n = int(cell.mix["checked_steps"])
    exact = train_ref.reference_steps(base, cfg, data, loader_seed,
                                      gen_seed, n, device)
    low = train_ref.reference_steps(base, cfg, data, loader_seed, gen_seed,
                                    n, device, exact=False)
    return train_ref.compare_train(low, exact)


def search_control(cell: harness.Cell, seed: int, device) -> dict:
    """The reference's top k in TF32 in the program's place, for a single
    query and one full batch of the pool drawn from the seed."""
    import numpy as np

    from benchmark.loops import search
    from benchmark.reference import search_ref

    cfg, mix = cell.config, cell.mix
    data = inputs.eval_inputs(cfg, mix, seed, device)
    base = inputs.weights(cfg, seed, device)
    nq, bsz = cfg["n_queries"], int(mix["query_bsz"])
    draw = search.stream(seed, search.WARM)
    row, start = int(draw.integers(nq)), int(draw.integers(nq))
    rows = np.concatenate([[row], np.arange(start, start + bsz) % nq])
    k = search.top_k_of(cell)
    exact = search_ref.fused_scores(base, cfg, data, rows, device)
    low = search_ref.fused_scores(base, cfg, data, rows, device,
                                  exact=False)
    vals, ids = search_ref.top_k(low, k)
    return search_ref.compare_search(vals.cpu().numpy(), ids.cpu().numpy(),
                                     exact, k,
                                     cell.params["limits"]["scores_abs_err"])


CONTROLS = {"eval": eval_control, "train": train_control,
            "search": search_control}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--fault", choices=sorted(faults.FAULTS),
                   help="plant this fault in the program for its seeds")
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    device = torch.device("cuda")
    drive = harness.loop(cell.mix["loop"])
    side = f"fault {args.fault}" if args.fault else "program"
    for seed in [int(s) for s in args.program_seeds.split(",") if s]:
        undo = faults.FAULTS[args.fault]() if args.fault else None
        try:
            r = drive.run(cell, seed, args.seconds, False, device,
                          time.perf_counter())
        finally:
            if undo:
                undo()
        print(json.dumps({"side": side, "seed": seed, "checks": r.checks}),
              flush=True)
        torch.cuda.empty_cache()
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        checks = CONTROLS[cell.mix["loop"]](cell, seed, device)
        print(json.dumps({"side": "control", "seed": seed,
                          "checks": checks}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
