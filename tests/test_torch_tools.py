"""The port's benches against the JAX package's, on the CPU.

- `tools/workload.py` against the root bench.py: the constants and the
  serving model configuration, field for field.
- The cold-start fleet drill's host logic (populate failure, replica
  errors, all green, a replica timeout) and `--policy both`: the port's
  `coldstart_bench.main` and the JAX tool's, with the same stubbed
  subprocess results, print the same JSON (their command lines differ by
  the module); `--mesh` runs on a one-shard CPU mesh.
- Each tool's `main` at a tiny count (a few videos and queries, the
  published widths) with `--torch_device cpu`: one JSON line with the JAX
  tool's keys or rows.
- The port bench's two full-eval functions and stream_bench's block-major
  streaming scores against the same composition of the JAX package's
  functions (Pallas kernels in interpret mode), weights carried across by
  `convert.state_dict_from_jax`, on the same numpy inputs. Tolerances: f32
  config, exact fused scores within 1e-5 (f32 products summed in another
  order) and equal ranks; int8 scores within 8e-3 (a tower output within
  f32 rounding of a quantization boundary moves one component a level, as
  tests/test_torch_int8.py allows); bf16 serving config, within 3e-2
  (ROADMAP C8: the bf16 towers' roundings).
"""

import dataclasses
import json
import os
import re
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
from dldkd_tpu.config import ModelConfig as JaxModelConfig
from dldkd_tpu.metrics import rank_of_gt as jax_rank_of_gt
from dldkd_tpu.models import DLDKD as JaxDLDKD
from dldkd_tpu.ops import fast_eval as jax_fast_eval
from dldkd_tpu.ops import similarity as jax_sim
from dldkd_tpu.ops.pallas import sim_max as jax_sm
from dldkd_tpu.tools import coldstart_bench as jax_coldstart
from dldkd_tpu.train import init_params
from dldkd_tpu_torch.config import ModelConfig
from dldkd_tpu_torch.convert import load_jax_params
from dldkd_tpu_torch.models import DLDKD
from dldkd_tpu_torch.ops.fast_eval import tower_weights
from dldkd_tpu_torch.tools import bench as port_bench
from dldkd_tpu_torch.tools import coldstart_bench, search_bench, stage_bench
from dldkd_tpu_torch.tools import stream_bench, train_bench
from dldkd_tpu_torch.tools import workload as wl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _torch_numerics():
    threads = torch.get_num_threads()
    precision = torch.get_float32_matmul_precision()
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(threads)
    torch.set_float32_matmul_precision(precision)


def _source(*parts):
    with open(os.path.join(REPO, *parts)) as f:
        return f.read()


# ------------------------------------------------------------ the workload

def test_workload_matches_bench_py():
    for name in ("N_VIDEOS", "N_QUERIES", "L_FRAMES", "D_STUDENT", "D_QUERY",
                 "L_TOKENS", "L_TOK_PAD", "QUERY_BSZ"):
        assert getattr(wl, name) == getattr(jax_bench, name), name
    assert dataclasses.asdict(wl.serving_model_config()) \
        == dataclasses.asdict(jax_bench.serving_model_config())


def test_one_branch_model_holds_the_inheritance_weights():
    dual = wl.serving_model(3)
    one = wl.serving_model(one_branch_of=dual)
    assert not one.config.double_branch and len(one.branches) == 1
    sd = dual.state_dict()
    for k, v in one.state_dict().items():
        assert torch.equal(v, sd[k]), k


# ------------------------------------------------- the fleet drill's logic

class _Proc:
    def __init__(self, returncode=0, stdout="", stderr=""):
        self.returncode = returncode
        self.stdout = stdout
        self.stderr = stderr


def _ok(first, search=0.5):
    return _Proc(stdout=json.dumps({"policy": "artifact",
                                    "first_result_s": first,
                                    "first_search_s": search}))


def _timeout(cmd, **kw):
    raise subprocess.TimeoutExpired(cmd, kw.get("timeout"))


# each scenario: (argv, the subprocess results in order; a callable is
# called with the command instead)
SCENARIOS = {
    "populate_failure": (["--policy", "fleet", "--replicas", "3"],
                         [_Proc(returncode=1, stderr="boom: no GPU")]),
    "replica_errors": (["--policy", "fleet", "--replicas", "3"],
                       [_ok(9.0), _ok(5.0), _Proc(returncode=2,
                                                  stderr="replica OOM"),
                        _ok(7.0)]),
    "all_green": (["--policy", "fleet", "--replicas", "4"],
                  [_ok(3.0), _ok(4.0), _ok(2.0), _ok(6.0), _ok(5.0)]),
    "replica_timeout": (["--policy", "fleet", "--replicas", "3"],
                        [_ok(8.0), _ok(4.0), _timeout, _ok(3.0)]),
    "populate_timeout": (["--policy", "fleet", "--replicas", "2"],
                         [_timeout]),
    "both": (["--policy", "both"],
             [_ok(1.0), _Proc(returncode=1, stderr="nvcc failed"),
              _ok(2.0), _ok(3.0), _ok(4.0), _ok(5.0)]),
}


def _drive(module, monkeypatch, tmp_path, capsys, argv, results):
    """main(argv) under a stubbed subprocess.run that plays `results`;
    (printed JSON, returned dict, the commands run)."""
    monkeypatch.setenv("HOME", str(tmp_path))
    seq, cmds = iter(results), []

    def runner(cmd, **kw):
        cmds.append(cmd)
        r = next(seq)
        return r(cmd, **kw) if callable(r) else r

    monkeypatch.setattr(module.subprocess, "run", runner)
    out = module.main(argv)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return printed, out, cmds


def _fleet(monkeypatch, tmp_path, capsys, results, replicas):
    printed, out, cmds = _drive(
        coldstart_bench, monkeypatch, tmp_path, capsys,
        ["--policy", "fleet", "--replicas", str(replicas)], results)
    assert printed == out
    return out, cmds


def test_fleet_populate_failure_aborts_whole_drill(monkeypatch, tmp_path,
                                                   capsys):
    """A dead populate process runs no replica and reports populate plus
    every replica as errors."""
    out, cmds = _fleet(monkeypatch, tmp_path, capsys,
                       [_Proc(returncode=1, stderr="boom: no GPU")], 3)
    assert len(cmds) == 1
    assert out["errors"] == 4
    assert "boom" in out["populate"]["error"]
    assert out["replicas"] == []
    assert "p50_first_result_s" not in out


def test_fleet_replica_errors_are_surfaced(monkeypatch, tmp_path, capsys):
    out, _ = _fleet(monkeypatch, tmp_path, capsys,
                    SCENARIOS["replica_errors"][1], 3)
    assert out["errors"] == 1
    assert out["p50_first_result_s"] == 7.0   # upper middle of [5.0, 7.0]
    assert out["p95_first_result_s"] == 7.0
    assert sum(1 for r in out["replicas"] if "error" in r) == 1


def test_fleet_all_green(monkeypatch, tmp_path, capsys):
    out, cmds = _fleet(monkeypatch, tmp_path, capsys,
                       SCENARIOS["all_green"][1], 4)
    assert "errors" not in out
    assert out["p50_first_result_s"] == 5.0   # upper middle of [2, 4, 5, 6]
    assert out["p95_first_result_s"] == 6.0
    assert len(out["replicas"]) == 4
    assert all(c[1:4] == ["-m", "dldkd_tpu_torch.tools.coldstart_bench",
                          "--policy"] and c[4] == "artifact" for c in cmds)
    # the drill removes its artifact on the way out
    assert not (tmp_path / ".cache" / "dldkd_torch_index_bench").exists()


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_fleet_and_both_equal_the_jax_tool(scenario, monkeypatch, tmp_path,
                                           capsys):
    """The same stubbed subprocess results through both tools give the
    same JSON; only the command lines differ (the module run)."""
    argv, results = SCENARIOS[scenario]
    port, _, port_cmds = _drive(coldstart_bench, monkeypatch, tmp_path,
                                capsys, argv, results)
    want, _, jax_cmds = _drive(jax_coldstart, monkeypatch, tmp_path, capsys,
                               argv, results)
    assert port == want
    assert len(port_cmds) == len(jax_cmds)
    for p, j in zip(port_cmds, jax_cmds):
        assert p[2] == "dldkd_tpu_torch.tools.coldstart_bench"
        assert j[2] == "dldkd_tpu.tools.coldstart_bench"
        assert p[3:9] == j[3:9]   # the policy and the corpus size


def test_mesh_raises_naming_a14(capsys, monkeypatch, tmp_path):
    """--mesh runs the retriever on a one-shard CPU mesh (the sharded
    route) and prints the policy's JSON line."""
    monkeypatch.setenv("HOME", str(tmp_path))
    built = []
    real = coldstart_bench._measure

    def measure(*args):
        built.append(args[-1])
        return real(*args)

    monkeypatch.setattr(coldstart_bench, "_measure", measure)
    out = coldstart_bench.main(["--policy", "cold", "--mesh", "--n_videos",
                                "12", "--n_queries", "3", "--torch_device",
                                "cpu"])
    assert built == [True]
    assert json.loads(capsys.readouterr().out.strip()) == out
    assert set(out) == {"policy", "first_result_s", "index_s",
                        "first_search_s"}
    assert out["first_result_s"] >= out["first_search_s"] > 0


# -------------------------------------------------- each tool, tiny, CPU

def _small_pads(monkeypatch, video_grid, query_grid=8):
    monkeypatch.setattr(wl, "VIDEO_GRID", video_grid)
    monkeypatch.setattr(wl, "QUERY_BSZ", query_grid)


def test_stage_bench_rows_are_the_jax_tools(capsys, monkeypatch):
    _small_pads(monkeypatch, 4)
    rec = stage_bench.main(["--reps", "1", "--n_videos", "3",
                            "--n_queries", "5", "--torch_device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip()) == rec
    rows = re.findall(r'timed\("([^"]+)"',
                      _source("dldkd_tpu", "tools", "stage_bench.py"))
    assert len(rows) == 12 and list(rec["stages_ms"]) == rows
    assert all(v > 0 for v in rec["stages_ms"].values())
    assert (rec["videos_padded"], rec["queries_padded"]) == (4, 8)
    assert rec["sum_ms"] == pytest.approx(sum(
        rec["stages_ms"][k] for k in stage_bench.SUM_ROWS))


def test_search_bench_rows_and_ids(capsys, tmp_path, monkeypatch):
    _small_pads(monkeypatch, 16)
    ids = tmp_path / "ids.npy"
    out = search_bench.main(["--reps", "2", "--n_queries", "4",
                             "--n_videos", "12", "--ids_out", str(ids),
                             "--torch_device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip()) == out
    rows = re.findall(r'timed\("(\w+)"',
                      _source("dldkd_tpu", "tools", "search_bench.py"))
    assert list(out) == rows and all(v > 0 for v in out.values())
    got = np.load(ids)
    # k = 10 of 12 videos: padded videos never win
    assert got.shape == (4, search_bench.K) == (4, 10) and got.max() < 12


def test_stream_bench_keys(capsys, monkeypatch):
    _small_pads(monkeypatch, 4)
    monkeypatch.setattr(stream_bench, "BLOCK", 4)
    out = stream_bench.main(["--scale", "2", "--reps", "1", "--host",
                             "--n_videos", "3", "--n_queries", "5",
                             "--host_queries", "6", "--torch_device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip()) == out
    assert set(out) == {"metric", "unit", "value", "detail", "host_stream"}
    assert out["metric"] == "streaming_eval_throughput"
    assert set(out["detail"]) == {"qps", "seconds_per_pass", "videos",
                                  "scale"}
    assert out["detail"]["videos"] == 6 and out["value"] > 0
    assert set(out["host_stream"]) == {"seconds", "videos", "queries"}


@pytest.mark.parametrize("policy", ["cold", "warm"])
def test_coldstart_policy_keys(policy, capsys, monkeypatch, tmp_path):
    monkeypatch.setenv("HOME", str(tmp_path))
    out = coldstart_bench.main(["--policy", policy, "--n_videos", "12",
                                "--n_queries", "3", "--torch_device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip()) == out
    keys = {"policy", "first_result_s", "index_s", "first_search_s"}
    if policy == "warm":   # the port never swaps paths: nothing to time
        keys |= {"int8_ready_s", "int8_search_s"}
        assert out["int8_ready_s"] is None and out["int8_search_s"] is None
    assert set(out) == keys
    assert out["first_result_s"] >= out["first_search_s"] > 0


def test_port_bench_line_has_bench_py_keys(capsys, monkeypatch):
    src = _source("bench.py")
    assert all(f'"{k}":' in src for k in port_bench.BENCH_KEYS)
    fleet = {"populate": {"first_result_s": 9.0},
             "replicas": [{"first_result_s": 2.0, "first_search_s": 0.5},
                          {"first_result_s": 3.0, "first_search_s": 0.25}],
             "p50_first_result_s": 3.0, "p95_first_result_s": 3.0}
    cmds = []

    def runner(cmd, **kw):
        cmds.append(cmd)
        return _Proc(stdout=json.dumps(fleet))

    monkeypatch.setattr(port_bench.subprocess, "run", runner)
    _small_pads(monkeypatch, 8)
    monkeypatch.setattr(stream_bench, "BLOCK", 4)
    monkeypatch.setattr(train_bench, "WORKLOAD",
                        dict(train_bench.WORKLOAD, bsz=2))
    line = port_bench.main([
        "--torch_device", "cpu", "--n_videos", "5", "--n_queries", "6",
        "--reps", "1", "--train_steps", "1", "--stream_scale", "2",
        "--stream_reps", "1"])
    assert json.loads(capsys.readouterr().out.strip()) == line
    assert set(port_bench.BENCH_KEYS) <= set(line)
    assert line["metric"] == "t2v_retrieval_throughput" and line["value"] > 0
    assert line["vs_baseline"] is None and line["device"] == "cpu"
    assert line["exact_bf16"]["vs_baseline"] is None
    for key in ("train", "train_bf16", "train_bf16_stacked"):
        assert line[key]["value"] > 0 and line[key]["vs_baseline"] is None
    assert line["train_speed"]["value"] is None
    assert "rbg" in line["train_speed"]["reason"]
    assert line["train_scan"]["f32_parity"] is None   # no device on a CPU
    assert cmds[0][2:6] == ["dldkd_tpu_torch.tools.coldstart_bench",
                            "--policy", "fleet", "--replicas"]
    assert line["coldstart_fleet"]["p50_first_result_s"] == 3.0
    assert line["coldstart_fleet"]["max_first_search_s"] == 0.5
    assert line["streaming_8x"]["videos"] == 10


def test_port_bench_fleet_failure_raises(monkeypatch):
    """No part's failure is written into the line: a replica error
    raises."""
    res = {"populate": {}, "replicas": [{"error": "x"}], "errors": 1}
    monkeypatch.setattr(port_bench.subprocess, "run",
                        lambda cmd, **kw: _Proc(stdout=json.dumps(res)))
    with pytest.raises(RuntimeError, match="fleet drill"):
        port_bench.bench_coldstart_fleet(1, 12, "cpu")
    monkeypatch.setattr(port_bench.subprocess, "run",
                        lambda cmd, **kw: _Proc(returncode=1, stderr="dead"))
    with pytest.raises(RuntimeError, match="dead"):
        port_bench.bench_coldstart_fleet(1, 12, "cpu")


# --------------------------------------- the eval compositions against JAX

_DIMS = dict(visual_input_size=24, query_input_size=16, inheritance_hidden=16,
             exploration_hidden=16, max_ctx_l=8, max_desc_l=6, n_heads=2,
             double_branch=True, label_style="soft")
_NV, _NQ = 6, 5


def _pair(dtype):
    precision = "highest" if dtype == "float32" else "default"
    jcfg = JaxModelConfig(dtype=dtype, matmul_precision=precision, **_DIMS)
    params = init_params(JaxDLDKD(config=jcfg), jcfg, 0)
    model = load_jax_params(
        DLDKD(ModelConfig(dtype=dtype, matmul_precision=precision, **_DIMS)),
        jax.tree.map(np.asarray, params)).eval()
    return jcfg, params, model


def _eval_inputs(nv=_NV, seed=11):
    """bf16-representable corpus (the benches store it in bf16), ragged
    masks with an all-masked video, 8-token query buffers of 6 tokens."""
    rng = np.random.RandomState(seed)
    vf = np.asarray(jnp.asarray(rng.rand(nv, 8, 24), jnp.bfloat16))
    vm = (rng.rand(nv, 8) < 0.8).astype(np.float32)
    vm[:, 0] = 1.0
    vm[2] = 0.0
    qf = rng.rand(_NQ, 8, 16).astype(np.float32)
    qm = np.tile((np.arange(8) < 6).astype(np.float32), (_NQ, 1))
    qm[1, 4:] = 0.0
    gt = (np.arange(_NQ) * 5 % nv).astype(np.int32)
    gt[gt == 2] = 1                    # no ground truth on the masked video
    return vf, vm, qf, qm, gt


def _jax_scores(route, jcfg, params, vf, vm, qf, qm):
    kw = dict(prefer_pallas=True, interpret=True)
    vf_j = jnp.asarray(vf, jnp.bfloat16)
    vm_j, qf_j, qm_j = jnp.asarray(vm), jnp.asarray(qf), jnp.asarray(qm)
    qi, qe = jax_fast_eval.encode_query_best(params, jcfg, qf_j, qm_j, **kw)
    if route == "int8":
        q8_i, q8_e = jax_fast_eval.encode_context_q8(params, jcfg, vf_j, vm_j,
                                                     **kw)
        ct_i, bias = jax_sm.build_q8_index(q8_i, vm_j)
        ct_e, _ = jax_sm.build_q8_index(q8_e, vm_j)
        s = (jax_sim.clip_scores_maxpool_pre8(qi, ct_i, bias, **kw),
             jax_sim.clip_scores_maxpool_pre8(qe, ct_e, bias, **kw))
    else:
        ci, ce = jax_fast_eval.encode_context_best(params, jcfg, vf_j, vm_j,
                                                   **kw)
        s = (jax_sim.clip_scores_maxpool(qi, ci, vm_j, **kw),
             jax_sim.clip_scores_maxpool(qe, ce, vm_j, **kw))
    return tuple(np.asarray(x)[:, :vf.shape[0]] for x in s)


def _t(x, dtype=None):
    t = torch.from_numpy(np.asarray(x, np.float32))
    return t if dtype is None else t.to(dtype)


def _ranks_np(fused, gt):
    return np.asarray(jax_rank_of_gt(jnp.asarray(fused), jnp.asarray(gt)))


@pytest.mark.parametrize("route", ["exact", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_eval_matches_the_jax_composition(dtype, route):
    jcfg, params, model = _pair(dtype)
    vf, vm, qf, qm, gt = _eval_inputs()
    want = _jax_scores(route, jcfg, params, vf, vm, qf, qm)
    got = [s.numpy() for s in port_bench.full_eval_scores(
        route, model, tower_weights(model), _t(vf, torch.bfloat16), _t(vm),
        _t(qf), _t(qm))]
    valid = vm.max(axis=1) > 0
    tol = {("float32", "exact"): 1e-5, ("float32", "int8"): 8e-3}.get(
        (dtype, route), 3e-2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[:, valid], w[:, valid], atol=tol,
                                   rtol=0)
    fused_j = 0.7 * want[0] + 0.3 * want[1]
    ranks = port_bench.full_eval(route, model, tower_weights(model), {
        "vfeats": _t(vf, torch.bfloat16), "vmask": _t(vm), "qfeats": _t(qf),
        "qmask": _t(qm), "gt": torch.from_numpy(gt)}).numpy()
    np.testing.assert_array_equal(
        ranks, _ranks_np(0.7 * got[0] + 0.3 * got[1], gt))
    if (dtype, route) == ("float32", "exact"):
        np.testing.assert_array_equal(ranks, _ranks_np(fused_j, gt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streaming_scores_match_per_block_jax(dtype):
    """stream_bench's block-major int8 scores and ranks against per-block
    encode_context_best + clip_scores_maxpool(quantized=True) in JAX."""
    jcfg, params, model = _pair(dtype)
    block, n_blocks = 4, 2
    vf, vm, qf, qm, gt = _eval_inputs(nv=block * n_blocks, seed=12)
    kw = dict(prefer_pallas=True, interpret=True)
    qi, qe = jax_fast_eval.encode_query_best(params, jcfg, jnp.asarray(qf),
                                             jnp.asarray(qm), **kw)
    cols = []
    for b in range(n_blocks):
        bf = jnp.asarray(vf[b * block:(b + 1) * block], jnp.bfloat16)
        bm = jnp.asarray(vm[b * block:(b + 1) * block])
        ci, ce = jax_fast_eval.encode_context_best(params, jcfg, bf, bm, **kw)
        cols.append(0.7 * jax_sim.clip_scores_maxpool(qi, ci, bm,
                                                      quantized=True, **kw)
                    + 0.3 * jax_sim.clip_scores_maxpool(qe, ce, bm,
                                                        quantized=True, **kw))
    want = np.concatenate([np.asarray(c) for c in cols], axis=1)
    got = stream_bench.streaming_scores(
        model, tower_weights(model),
        _t(vf, torch.bfloat16).view(n_blocks, block, 8, 24),
        _t(vm).view(n_blocks, block, 8), _t(qf), _t(qm)).numpy()
    assert got.shape == want.shape == (_NQ, block * n_blocks)
    valid = vm.max(axis=1) > 0
    np.testing.assert_allclose(got[:, valid], want[:, valid],
                               atol=8e-3 if dtype == "float32" else 3e-2,
                               rtol=0)
    if dtype == "float32":
        np.testing.assert_array_equal(_ranks_np(got, gt),
                                      _ranks_np(want, gt))
