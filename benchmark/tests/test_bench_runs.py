"""Whole runs of each mix on the CPU at a tiny size (the kernels' plain
versions), the reference against the program, and runs with the timed
path broken underneath, which `correct` has to catch."""

import ast
import json
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import faults, harness
from benchmark import run as bench_run
from benchmark.tests.tiny import tiny_cell

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
SEED = 2**31 + 4099  # past 32 signed bits, as a check's seeds may be


def run_cell(name, seed=SEED, seconds=0.3, traced=False):
    return bench_run.run(name, seed, seconds, traced, CPU,
                         time.perf_counter(), cell=tiny_cell(name))


@pytest.mark.parametrize("name", ["activitynet.eval", "tvr.train"])
def test_tiny_run_is_correct(name):
    code, line = run_cell(name)
    assert code == 0
    assert line["correct"] is True, line["checks"]
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {m["name"] for m in
                                    tiny_cell(name).end_to_end}
    assert line["attempted"] >= 1 and line["failed"] == 0
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


def test_eval_rate_is_all_queries_over_the_window(monkeypatch):
    from benchmark.loops import eval as drv

    cell = tiny_cell("activitynet.eval")
    r = drv.run(cell, 5, 0.2, False, CPU, time.perf_counter())
    assert r.metrics["eval_qps"] == pytest.approx(
        r.units * cell.config["n_queries"] / r.window_s)


def test_same_seed_same_inputs_and_weights():
    from benchmark import inputs

    cfg, mix = tiny_cell("activitynet.eval").config, \
        tiny_cell("activitynet.eval").mix
    a, b = inputs.eval_inputs(cfg, mix, SEED, CPU), \
        inputs.eval_inputs(cfg, mix, SEED, CPU)
    c = inputs.eval_inputs(cfg, mix, SEED + 1, CPU)
    assert all((a[k] == b[k]).all() for k in a)
    assert not (a["vfeats"] == c["vfeats"]).all()
    # another seed: the same lengths in another order
    assert sorted(a["vmask"].sum(1)) == sorted(c["vmask"].sum(1))
    wa, wb = inputs.weights(cfg, SEED, CPU), inputs.weights(cfg, SEED, CPU)
    assert all(torch.equal(wa[k], wb[k]) for k in wa)


def test_traced_run_without_cuda_events_fails():
    code, line = run_cell("activitynet.eval", traced=True)
    assert code == 4 and line is None


@pytest.mark.parametrize("name,fault", [
    ("activitynet.eval", "alter_scores"),
    ("tvr.train", "unchanged_state"),
    ("tvr.train", "half_batch"),
])
def test_broken_timed_path_is_not_correct(name, fault):
    undo = faults.FAULTS[fault]()
    try:
        code, line = run_cell(name)
    finally:
        undo()
    assert code == 0
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("loaded,bad", [
    ("dldkd_tpu_torch.evaluate", []),
    ("dldkd_tpu_torchx", []),
    ("dldkd_tpu", ["dldkd_tpu"]),
    ("dldkd_tpu.ops.pallas", ["dldkd_tpu"]),
    ("jax.numpy", ["jax"]),
    ("flax", ["flax"]),
])
def test_forbidden_modules_by_whole_top_level_name(monkeypatch, loaded, bad):
    for m in [m for m in list(sys.modules)
              if m.split(".")[0] in harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, loaded, object())
    assert harness.forbidden_modules() == bad


def test_no_benchmark_file_imports_jax_or_the_tools():
    banned = ("jax", "jaxlib", "flax", "dldkd_tpu", "bench")
    for path in (ROOT / "benchmark").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in banned, (path, n)
                assert not n.startswith("dldkd_tpu_torch.tools"), (path, n)
                if "reference" in path.parts:
                    assert not n.startswith("dldkd_tpu_torch"), (path, n)


def test_benchmark_json_names_its_files():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    layers = {}
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in spec["workloads"]:
        assert (ROOT / "benchmark" / "cells" / f"{w['name']}.json").is_file()
        assert (ROOT / "benchmark" / "mixes" / f"{w['traffic']}.json"
                ).is_file()
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert "setup_s" in e2e


def test_training_run_leaves_no_thread():
    import threading

    before = threading.active_count()
    code, _ = run_cell("tvr.train")
    assert code == 0
    assert threading.active_count() == before


def test_staged_cell_loads_and_unknown_cell_is_refused():
    cell = harness.load_cell("tvr.train")
    assert cell.mix["loop"] == "train"
    assert [m["name"] for m in cell.end_to_end] == ["train_videos_per_s",
                                                    "setup_s"]
    code, line = bench_run.run("no.such.cell", SEED, 1.0, False, CPU,
                               time.perf_counter())
    assert code == 2 and line is None
