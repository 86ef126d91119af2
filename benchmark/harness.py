"""The benchmark's general part: it finds a cell's files by the names in
BENCHMARK.json, checks the device, hands the cell to its mix's loop,
reads the per-layer metrics, and prints the result.

Files, found by name (each added as a file of its own, never by an edit):

  configs/<config>.json  the configuration's sizes, source and cuts
  mixes/<traffic>.json   the traffic mix's parameters; "loop" names the
                         module under loops/ that runs this kind of work
                         (eval, train)
  cells/<workload>.json  the cell's own parameters: the limits of the
                         numbers that decide `correct`; a staged cell
                         (one not yet in BENCHMARK.json) also holds its
                         entries for BENCHMARK.json under "staged"
  metrics/<metric>.py    a per-layer metric's reader: `read(run) ->
                         float or None`

A loop returns a `Result`; with `--trace 1` it also holds the traced
window (`trace.Trace`), which the metric readers read.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dldkd_tpu")


class Refused(Exception):
    """A run that must print no result (exit code 2)."""


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    params: dict
    end_to_end: List[dict]
    per_layer: List[dict]


@dataclass
class Result:
    attempted: int
    failed: int
    metrics: Dict[str, float]            # end-to-end values, by name
    checks: Dict[str, float]             # numbers compared, by name
    window_s: float                      # the measured window
    units: int                           # calls or steps in the window
    memory_peak_bytes: int
    extra: Dict[str, float] = field(default_factory=dict)
    trace: Optional[object] = None       # trace.Trace of a traced run
    work: Dict[str, float] = field(default_factory=dict)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> Cell:
    """The cell named in BENCHMARK.json, or a staged one: a cell whose
    file holds, under "staged", the entries it would add to
    BENCHMARK.json (its configuration, workload and metrics), so that it
    runs before it is entered there."""
    spec = load_json(ROOT / "BENCHMARK.json")
    params = load_json(HERE / "cells" / f"{name}.json") \
        if (HERE / "cells" / f"{name}.json").is_file() else {}
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        if "staged" not in params:
            raise Refused(f"no workload {name!r} in BENCHMARK.json")
        staged = params["staged"]
        spec = {"configs": [staged["config"]],
                "end_to_end": staged["end_to_end"],
                "per_layer": staged["per_layer"]}
        cells = {name: staged["workload"]}
    w = cells[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = load_json(ROOT / cfg_entry["file"])
    mix = load_json(HERE / "mixes" / f"{w['traffic']}.json")

    def mine(metric):
        return "workloads" not in metric or name in metric["workloads"]

    return Cell(name=name, chips=w["chips"], config=config, mix=mix,
                params=params,
                end_to_end=[m for m in spec["end_to_end"] if mine(m)],
                per_layer=[m for m in spec["per_layer"] if mine(m)])


def metric_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def loop(kind: str):
    return importlib.import_module(f"benchmark.loops.{kind}")


def require_cuda(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise Refused("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise Refused(f"{torch.cuda.device_count()} CUDA devices, the cell "
                      f"needs {chips}")


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is JAX's, Flax's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def card() -> Dict[str, str]:
    """The card's power limit by nvidia-smi; empty without it."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return {}
    line = out.stdout.strip().splitlines()[:1]
    if out.returncode != 0 or not line:
        return {}
    return {"power_limit": line[0].strip()}


def judge(checks: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit, and finite; every limit has
    its number."""
    return all(k in checks and math.isfinite(checks[k])
               and checks[k] <= limits[k] for k in limits)


def per_layer_values(cell: Cell, result: Result) -> Dict[str, dict]:
    out = {}
    for m in cell.per_layer:
        v = metric_reader(m["name"])(result)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def end_to_end_values(cell: Cell, result: Result) -> Dict[str, dict]:
    return {m["name"]: {"value": float(result.metrics[m["name"]]),
                        "unit": m["unit"]}
            for m in cell.end_to_end}


def result_line(cell: Cell, result: Result, traced: bool, device: dict
                ) -> dict:
    limits = cell.params["limits"]
    line = {"correct": judge(result.checks, limits),
            "attempted": result.attempted, "failed": result.failed,
            "metrics": (per_layer_values(cell, result) if traced
                        else end_to_end_values(cell, result)),
            "device": device}
    if traced:
        from benchmark import trace

        line["breakdown"] = trace.breakdown(result.trace)
    line["checks"] = {k: {"value": result.checks.get(k, math.nan),
                          "limit": limits[k]} for k in limits}
    return line
