"""Run one cell of the benchmark of the PyTorch / H100 port
(`dldkd_tpu_torch`) and print its result as the last line of stdout.

    python3 benchmark/run.py --workload activitynet.eval --seed 7 \
        --seconds 30 --trace 0

From the root of a checkout. --trace 0 prints the cell's end-to-end
metrics, --trace 1 its per-layer metrics (read from torch.profiler over a
few calls of the window) and the trace's breakdown. Every run checks what
the timed path produced against the plain reference (`correct`); the
numbers compared and their limits are the last lines of stderr and the
`checks` key of the result. Exit codes: 0 with a result; 2 refused (no
CUDA card, too few cards, an unknown cell); 3 JAX or the JAX package
loaded; 4 a traced run that saw no CUDA kernel; anything else a failure.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run(workload: str, seed: int, seconds: float, traced: bool, device,
        t_start: float, cell=None):
    """(exit code, result line or None). `device` None means the card,
    checked against the cell's chips; tests pass a CPU device and a
    `harness.Cell` of their own."""
    import torch

    from benchmark import harness, trace

    try:
        cell = cell or harness.load_cell(workload)
        if device is None:
            harness.require_cuda(cell.chips)
            device = torch.device("cuda")
    except harness.Refused as e:
        print(f"refused: {e}", file=sys.stderr)
        return 2, None
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    result = harness.loop(cell.mix["loop"]).run(
        cell, seed, seconds, traced, device, t_start)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3, None
    if traced and not result.trace.kernels:
        print("the traced window saw no CUDA kernel", file=sys.stderr)
        return 4, None
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips,
           "memory_peak_bytes": result.memory_peak_bytes}
    if traced:
        dev["busy_s"] = trace.length(result.trace.busy_spans()) * 1e-6
        dev["window_s"] = result.trace.window_s()
    dev.update(harness.card())
    line = harness.result_line(cell, result, traced, dev)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return 0, line


def main(argv=None) -> int:
    args = parse(argv)
    code, line = run(args.workload, args.seed, args.seconds,
                     bool(args.trace), None, T_START)
    if line is not None:
        print(json.dumps(line), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
