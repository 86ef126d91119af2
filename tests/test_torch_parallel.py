"""The port's multi-GPU training and corpus-sharded eval
(`dldkd_tpu_torch/parallel/`) on the CPU, against the single-device port
and the JAX package's `dldkd_tpu/parallel/`.

- Sharded eval: meshes of 1, 2, 3 and 8 shards on the CPU
  (`make_mesh(devices=["cpu"] * n)`, several shards on one device) on 21
  videos (no mesh size but 1 divides them), resident, streaming and
  resident int8 (`score_quant`), two-branch and one-branch models: the
  metric dicts equal the single-device port's and
  `dldkd_tpu.parallel.eval_retrieval_sharded{,_streaming}`'s on the JAX
  suite's 8 CPU devices; the score matrices within 1e-5 of the
  single-device port's (f32; the plain versions' products at other
  shapes round differently). A one-branch model scores its corpus once
  per query batch.
- Data-parallel step: two gloo ranks (subprocesses of
  `test_torch_parallel_worker.py`, one torch thread, highest precision)
  against the single-device step, with dropout on, plain and with
  stacked towers: losses and parameters within rtol 2e-4, atol 1e-6 (as
  tests/test_parallel.py:85-91); with dropout 0 and hard negatives from a
  pool of 1, also against `dldkd_tpu.parallel.make_dp_train_step` on a
  JAX mesh of 2 (the same tolerance). The ranks end in the same
  parameters, and the stop agreement stops both when one is flagged.
- The training cycle (`train.start_training`) of two ranks against one
  process, as tests/test_multihost.py:101-142: per-epoch losses as logged
  (4 decimals) within 1e-4, validation SumRs equal, only rank 0's files
  (checkpoints, train.log.txt, metrics.jsonl), and the preemption
  agreement.
- The mesh-size rule and drop_last (tests/test_train_dp_driver.py).
"""

import json
import math
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dldkd_tpu.config import ModelConfig as JaxModelConfig
from dldkd_tpu.config import TrainConfig as JaxTrainConfig
from dldkd_tpu.data.pipeline import TrainLoader as JaxTrainLoader
from dldkd_tpu.models import DLDKD as JaxDLDKD
from dldkd_tpu.models.objective import LossScalars as JaxLossScalars
from dldkd_tpu.optim import bert_adam as jax_bert_adam
from dldkd_tpu.optim import default_wd_mask as jax_wd_mask
from dldkd_tpu.parallel import (eval_retrieval_sharded as jax_sharded,
                                eval_retrieval_sharded_streaming
                                as jax_sharded_streaming)
from dldkd_tpu.parallel import make_dp_train_step as jax_dp_step
from dldkd_tpu.parallel import make_mesh as jax_make_mesh
from dldkd_tpu.parallel import shard_batch as jax_shard_batch
from dldkd_tpu.train import init_params as jax_init_params
from dldkd_tpu_torch import evaluate, train
from dldkd_tpu_torch.config import ModelConfig, parse_args
from dldkd_tpu_torch.convert import load_jax_params, state_dict_from_jax
from dldkd_tpu_torch.data import TrainLoader
from dldkd_tpu_torch.data.ingest import PackedQueries, PackedVideos
from dldkd_tpu_torch.models import DLDKD
from dldkd_tpu_torch.parallel import make_mesh, shard_rows
from dldkd_tpu_torch.parallel import eval_shard
from tests.test_torch_parallel_worker import step_once

WORKER = os.path.join(os.path.dirname(__file__),
                      "test_torch_parallel_worker.py")
# tests/test_parallel.py:23-44's model
DIMS = dict(visual_input_size=12, query_input_size=10, inheritance_hidden=8,
            exploration_hidden=8, max_ctx_l=8, max_desc_l=6, n_heads=2,
            label_style="soft")
N_VID, N_Q, QUERY_BSZ, BLOCK = 21, 40, 16, 8
# the resident engine's context batch per shard: at 2, 3 and 8 shards some
# shard's index pads past its rows, one falls short of them, one is empty
CONTEXT_BSZ = 5
SCORE_TOL = 1e-5
STEP_RTOL, STEP_ATOL = 2e-4, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _torch_numerics():
    threads = torch.get_num_threads()
    precision = torch.get_float32_matmul_precision()
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(threads)
    torch.set_float32_matmul_precision(precision)


# ------------------------------------------------------------ sharded eval

@pytest.fixture(scope="module")
def eval_data():
    """tests/test_parallel.py:124-137's corpus and queries, with ragged
    masks."""
    rng = np.random.RandomState(1)
    vfeats = rng.randn(N_VID, 8, 12).astype(np.float32)
    vmask = np.ones((N_VID, 8), np.float32)
    vmask[3, 5:] = 0
    vmask[rng.rand(N_VID, 8) < 0.2] = 0
    vmask[:, 0] = 1
    vids = [f"v{i}" for i in range(N_VID)]
    qfeats = rng.randn(N_Q, 6, 10).astype(np.float32)
    qmask = np.ones((N_Q, 6), np.float32)
    qmask[::3, 4:] = 0
    qvids = [vids[i % N_VID] for i in range(N_Q)]
    return (PackedVideos(feats=vfeats, mask=vmask, ids=vids),
            PackedQueries(feats=qfeats, mask=qmask,
                          cap_ids=[f"{v}#enc#{i}"
                                   for i, v in enumerate(qvids)],
                          video_ids=qvids))


_MODELS = {}


def _models(double: bool):
    """(JAX model, its params, the port's model on the same weights)."""
    if double not in _MODELS:
        jcfg = JaxModelConfig(double_branch=double, **DIMS)
        jmodel = JaxDLDKD(config=jcfg)
        params = jax_init_params(jmodel, jcfg, 0)
        model = load_jax_params(
            DLDKD(ModelConfig(double_branch=double, **DIMS)),
            jax.tree.map(np.asarray, params)).eval()
        _MODELS[double] = (jmodel, params, model)
    return _MODELS[double]


ROUTES = ("resident", "streaming", "q8")
_REFS = {}


def _eval_cfg(route, context_bsz=CONTEXT_BSZ):
    """The route's EvalConfig: resident, streaming in blocks of BLOCK, or
    resident int8; query batches of QUERY_BSZ (the router floors them)."""
    from dldkd_tpu_torch.config import EvalConfig

    return EvalConfig(eval_query_bsz=QUERY_BSZ, eval_context_bsz=context_bsz,
                      corpus_stream_bsz=BLOCK if route == "streaming" else -1,
                      score_quant=route == "q8")


def _references(route, double, videos, queries):
    """The single-device port's score matrices and metrics, and the JAX
    package's sharded metrics on its 8 CPU devices, for one route."""
    key = (route, double)
    if key not in _REFS:
        jmodel, params, model = _models(double)
        quant = route == "q8"
        if route == "streaming":
            scores = evaluate.stream_score_matrices(
                model, videos, queries, corpus_block=BLOCK,
                query_bsz=QUERY_BSZ, device="cpu")
            want_jax = jax_sharded_streaming(
                jmodel, params, videos, queries, jax_make_mesh(8),
                corpus_block=BLOCK, query_bsz=QUERY_BSZ)
        else:
            scores = evaluate.score_matrices(
                model, videos, queries, context_bsz=7, query_bsz=QUERY_BSZ,
                device="cpu", score_quant=quant)
            want_jax = jax_sharded(jmodel, params, videos, queries,
                                   jax_make_mesh(8), query_bsz=QUERY_BSZ,
                                   score_quant=quant)
        metrics = evaluate.run_retrieval_eval(
            model, videos, queries, _eval_cfg(route, context_bsz=7),
            device="cpu")
        _REFS[key] = (scores, metrics, want_jax)
    return _REFS[key]


def _assert_metrics_equal(got, want, what):
    assert set(got) == set(want), what
    for branch in want:
        for k, v in want[branch].items():
            assert got[branch][k] == pytest.approx(v, abs=1e-9), \
                (what, branch, k)


@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
@pytest.mark.parametrize("double", [True, False], ids=["2br", "1br"])
@pytest.mark.parametrize("route", ROUTES)
def test_sharded_eval_matches_single_device_and_jax(eval_data, route,
                                                    double, n_shards):
    videos, queries = eval_data
    _, _, model = _models(double)
    (want_i, want_e), want, want_jax = _references(route, double, videos,
                                                   queries)
    mesh = make_mesh(devices=["cpu"] * n_shards)
    quant = route == "q8"
    block = BLOCK if route == "streaming" else 0
    got_i, got_e = eval_shard.sharded_score_matrices(
        model, videos, queries, mesh, query_bsz=QUERY_BSZ,
        score_quant=quant, corpus_block=block, context_bsz=CONTEXT_BSZ)
    assert got_i.shape == (N_Q, N_VID)
    assert (got_e is None) == (want_e is None) == (not double)
    np.testing.assert_allclose(got_i.numpy(), want_i[:, :N_VID].numpy(),
                               atol=SCORE_TOL, rtol=0)
    if double:
        np.testing.assert_allclose(got_e.numpy(),
                                   want_e[:, :N_VID].numpy(),
                                   atol=SCORE_TOL, rtol=0)
    got = evaluate.run_retrieval_eval(model, videos, queries,
                                      _eval_cfg(route), mesh=mesh)
    _assert_metrics_equal(got, want, "port single device")
    _assert_metrics_equal(got, want_jax, "dldkd_tpu sharded")


@pytest.mark.parametrize("route", ROUTES)
def test_one_branch_scores_the_corpus_once(eval_data, route, monkeypatch):
    """Each scorer call of a one-branch model scores the inheritance
    branch: one call per shard and query batch (resident) or per streamed
    block, half the two-branch model's."""
    videos, queries = eval_data
    mesh = make_mesh(devices=["cpu"] * 3)
    block = BLOCK if route == "streaming" else 0
    rows = [min(r.stop, N_VID) - r.start for r in shard_rows(N_VID, mesh)]
    per_block = math.ceil(BLOCK / mesh.size)
    want = (sum(math.ceil(r / per_block) for r in rows) if block
            else mesh.size * math.ceil(N_Q / QUERY_BSZ))
    for double, factor in ((False, 1), (True, 2)):
        calls = []
        # every route scores through evaluate's scorer calls
        for name in ("clip_scores_maxpool", "clip_scores_maxpool_pre8"):
            real = getattr(evaluate, name)
            monkeypatch.setattr(
                evaluate, name, lambda *a, _real=real, **k:
                calls.append(1) or _real(*a, **k))
        eval_shard.sharded_score_matrices(
            _models(double)[2], videos, queries, mesh, query_bsz=QUERY_BSZ,
            score_quant=route == "q8", corpus_block=block)
        monkeypatch.undo()
        assert len(calls) == factor * want, (double, len(calls), want)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "q8"])
def test_mesh_route_encodes_shards_in_context_batches(eval_data, quant,
                                                      monkeypatch):
    """run_retrieval_eval on a mesh hands eval_context_bsz to the resident
    sharded engine: each shard's videos reach the video towers in batches
    of that many (the device memory the engine policy counts on), and the
    metrics are the single-device eval's."""
    from dldkd_tpu_torch.config import EvalConfig

    videos, queries = eval_data
    _, _, model = _models(True)
    cfg = EvalConfig(eval_query_bsz=QUERY_BSZ, eval_context_bsz=CONTEXT_BSZ,
                     corpus_stream_bsz=-1, score_quant=quant)
    want = evaluate.run_retrieval_eval(model, videos, queries, cfg,
                                       device="cpu")
    name = "encode_context_q8" if quant else "encode_context_best"
    real, batches = getattr(evaluate, name), []
    monkeypatch.setattr(evaluate, name, lambda m, feats, *a, **k:
                        batches.append(feats.shape[0]) or real(m, feats, *a,
                                                               **k))
    mesh = make_mesh(devices=["cpu"] * 2)
    got = evaluate.run_retrieval_eval(model, videos, queries, cfg, mesh=mesh)
    rows = [min(r.stop, N_VID) - r.start for r in shard_rows(N_VID, mesh)]
    assert batches == [CONTEXT_BSZ] * sum(math.ceil(r / CONTEXT_BSZ)
                                          for r in rows)
    _assert_metrics_equal(got, want, "port single device")


def test_mesh_shapes():
    mesh = make_mesh(devices=["cpu"] * 3)
    assert mesh.size == 3 and mesh.n_processes == 1 and mesh.group is None
    assert mesh.local_shards() == [(i, torch.device("cpu"))
                                   for i in range(3)]
    assert shard_rows(21, make_mesh(devices=["cpu"] * 8)) == [
        slice(3 * s, 3 * s + 3) for s in range(8)]
    assert make_mesh(2, devices=["cpu"] * 5).size == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(devices=["cuda:0"])


# ------------------------------------------------------- worker processes

def _run_workers(world, args, attempts=3, timeout=600):
    """`world` worker processes of one gloo group on a free localhost
    port (a fresh port and processes on each retry: bind-then-close port
    picking races); their JSON lines by rank."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    failed = ""
    for _ in range(attempts):
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        procs = [subprocess.Popen(
            [sys.executable, WORKER, str(world), str(r), str(port),
             *map(str, args)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env)
            for r in range(world)]
        results, failed = [], ""
        for p in procs:
            try:
                out, err = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                    q.communicate()
                failed = "timeout"
                break
            if p.returncode != 0:
                failed = err[-3000:]
                continue
            results.append(json.loads(out.strip().splitlines()[-1]))
        if not failed:
            return sorted(results, key=lambda r: r["rank"])
        for q in procs:
            q.kill()
            q.communicate()
    raise AssertionError(failed)


# --------------------------------------------------- data-parallel step

STEP_MODEL = dict(DIMS, double_branch=True, use_hard_negative=True,
                  hard_pool_size=4)
SETTINGS = {
    "dropout": {"model": STEP_MODEL, "train": {"lr": 1e-3}},
    "dropout_stacked": {"model": STEP_MODEL,
                        "train": {"lr": 1e-3, "stacked_towers": True}},
    # deterministic in both packages: no dropout, the negative from a
    # pool of 1
    "no_dropout": {"model": dict(STEP_MODEL, input_drop=0.0, drop=0.0,
                                 hard_pool_size=1),
                   "train": {"lr": 1e-3}},
}
SEED, SCALARS = 42, (0.9, 0.8, 0.7)


def _step_batch(b=16, q=32):
    """tests/test_parallel.py:27-41's batch."""
    rng = np.random.RandomState(0)
    labels = np.sort(np.concatenate([np.arange(b), rng.randint(0, b, q - b)])
                     ).astype(np.int32)
    return {
        "student_videos": rng.randn(b, 8, 12).astype(np.float32),
        "student_videos_mask": np.ones((b, 8), np.float32),
        "teacher_videos": rng.randn(b, 8, 6).astype(np.float32),
        "student_text": rng.randn(q, 6, 10).astype(np.float32),
        "student_text_mask": np.ones((q, 6), np.float32),
        "teacher_text": rng.randn(q, 6).astype(np.float32),
        "text_labels": labels,
    }


# the sharded eval over a process group: each route's keywords
GROUP_EVAL = {"resident": dict(eval_query_bsz=QUERY_BSZ,
                               corpus_stream_bsz=-1),
              "streaming": dict(eval_query_bsz=QUERY_BSZ,
                                corpus_stream_bsz=BLOCK),
              "q8": dict(eval_query_bsz=QUERY_BSZ, corpus_stream_bsz=-1,
                         score_quant=True)}


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory, eval_data):
    """The two-rank step of every setting, from the JAX init's weights,
    then the sharded eval over the two ranks."""
    d = tmp_path_factory.mktemp("dp_step")
    batch = _step_batch()
    jcfg = JaxModelConfig(**STEP_MODEL)
    params = jax_init_params(JaxDLDKD(config=jcfg), jcfg, 0)
    state = state_dict_from_jax(jax.tree.map(np.asarray, params))
    np.savez(d / "batch.npz", **batch)
    torch.save(state, d / "init.pt")
    videos, queries = eval_data
    np.savez(d / "eval.npz", vfeats=videos.feats, vmask=videos.mask,
             vids=videos.ids, qfeats=queries.feats, qmask=queries.mask,
             cap_ids=queries.cap_ids, qvids=queries.video_ids)
    torch.save(_models(True)[2].state_dict(), d / "eval_model.pt")
    with open(d / "spec.json", "w") as f:
        json.dump({"seed": SEED, "scalars": SCALARS, "settings": SETTINGS,
                   "eval_model": dict(DIMS, double_branch=True),
                   "eval_routes": GROUP_EVAL}, f)
    ranks = _run_workers(2, ["step", str(d)])
    return batch, params, state, ranks, torch.load(d / "dp.pt")


def _assert_step_close(got_losses, got_params, want_losses, want_params,
                       what):
    for k, v in want_losses.items():
        np.testing.assert_allclose(got_losses[k], v, rtol=STEP_RTOL,
                                   atol=STEP_ATOL, err_msg=(what, k))
    assert set(got_params) == set(want_params)
    for k, v in want_params.items():
        np.testing.assert_allclose(np.asarray(got_params[k]),
                                   np.asarray(v), rtol=STEP_RTOL,
                                   atol=STEP_ATOL, err_msg=(what, k))


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_dp_step_matches_single_device(dp_run, setting):
    batch, _, state, ranks, dp = dp_run
    want_losses, want_params = step_once(SETTINGS[setting], batch, state,
                                         SEED, SCALARS)
    got = dp[setting]
    _assert_step_close(got["losses"], got["params"], want_losses,
                       want_params, setting)
    # both ranks hold the same losses and the same updated parameters
    assert ranks[0]["losses"][setting] == ranks[1]["losses"][setting]
    assert ranks[0]["checksums"][setting] == ranks[1]["checksums"][setting]
    # the step moved the parameters
    assert any(not torch.equal(got["params"][k], state[k]) for k in state)


def test_dp_step_matches_jax_mesh_of_two(dp_run):
    batch, params, _, _, dp = dp_run
    setting = SETTINGS["no_dropout"]
    jcfg = JaxModelConfig(**setting["model"])
    jmodel = JaxDLDKD(config=jcfg)
    tcfg = JaxTrainConfig(**setting["train"])
    opt = jax_bert_adam(tcfg.lr, None, wd_mask=jax_wd_mask(params))
    mesh = jax_make_mesh(2)
    step = jax_dp_step(jmodel, jcfg, tcfg, opt, mesh)
    rep = jax.device_put(jax.tree.map(np.copy, params),
                         jax.sharding.NamedSharding(
                             mesh, jax.sharding.PartitionSpec()))
    p2, _, d2 = step(rep, opt.init(rep), jax_shard_batch(batch, mesh),
                     jax.random.PRNGKey(SEED),
                     JaxLossScalars(*(np.float32(v) for v in SCALARS)))
    got = dp["no_dropout"]
    _assert_step_close(
        got["losses"], got["params"], {k: float(v) for k, v in d2.items()},
        state_dict_from_jax(jax.tree.map(np.asarray, p2)), "jax mesh of 2")


@pytest.mark.parametrize("route", ROUTES)
def test_group_sharded_eval_matches_single_device(dp_run, eval_data,
                                                  route):
    """Two ranks of two shards each (a mesh of 4 over the group, the
    columns all-gathered): every rank's metrics are the single-device
    port's."""
    _, want, _ = _references(route, True, *eval_data)
    for r in dp_run[3]:
        _assert_metrics_equal(r["eval"][route], want, route)


def test_stop_agreement(dp_run):
    """One rank flagged: both stop; no rank flagged: neither stops."""
    for r in dp_run[3]:
        assert r["agree_one"] is True and r["agree_none"] is False


# ---------------------------------------------------- the training cycle

@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    """tests/test_multihost.py:107-111's dataset (32 train videos: two
    whole batches of 16, so no batch is dropped)."""
    from dldkd_tpu.data.synthetic import generate_dataset

    root = str(tmp_path_factory.mktemp("dp_data"))
    generate_dataset(root, collection="synthetic", visual_feature="i3d",
                     n_videos={"train": 32, "val": 12, "test": 4},
                     frames_range=(4, 16), teacher_frames_range=(3, 10),
                     d_student=16, d_query=12, d_teacher=8, seed=6)
    return root


def test_two_rank_training_cycle_matches_one_process(synth_root, tmp_path):
    single = _run_workers(1, ["cycle", synth_root, tmp_path / "one"])[0]
    double = _run_workers(2, ["cycle", synth_root, tmp_path / "two"])
    full = single["full"]
    assert len(full["losses"]) == 2 and len(full["sumrs"]) == 2
    assert full["data_parallel"] == []
    for r in double:
        assert r["full"]["data_parallel"] == [
            "data-parallel: 2 of 2 devices / 2 processes"]
        np.testing.assert_allclose(r["full"]["losses"], full["losses"],
                                   atol=1e-4, rtol=0)
        assert r["full"]["sumrs"] == full["sumrs"]
    assert double[0]["full"]["losses"] == double[1]["full"]["losses"]
    # rank 0 writes the run's files, rank 1 none of them
    for key in ("best_ckpt", "train_log", "metrics_jsonl"):
        assert single["full"][key] and double[0]["full"][key], key
        assert not double[1]["full"][key], key
    # the guard latched on rank 0 only: the epoch-end agreement stops both
    # ranks after epoch 0, before its validation; one process stops at
    # its first step
    for r in [single] + double:
        assert len(r["preempt"]["losses"]) == 1
        assert r["preempt"]["sumrs"] == []
        assert r["preempt"]["best_ckpt"] is False
    assert single["preempt"]["preempt_ckpt"] is True
    assert double[0]["preempt"]["preempt_ckpt"] is True
    assert double[1]["preempt"]["preempt_ckpt"] is False


# ----------------------------------------- mesh-size rule and drop_last

def test_dp_mesh_size():
    """tests/test_train_dp_driver.py's run (12 train videos, --bsz 4,
    --query_pad_multiple 8) takes 4 of 8 JAX devices; the port takes the
    same d, and raises for a world that d does not fill."""
    assert train.dp_mesh_size(12, 4, 8, 8) == 4
    assert train.dp_mesh_size(12, 4, 8, 2) == 2
    assert train.dp_mesh_size(12, 4, 8, 1) == 1
    assert train.dp_mesh_size(12, 6, 4, 4) == 2
    assert train.dp_mesh_size(3, 4, 8, 8) == 1   # less than one batch


def test_training_refuses_a_world_the_batch_does_not_divide(synth_root,
                                                            tmp_path,
                                                            monkeypatch):
    cfg = parse_args([
        "--collection", "synthetic", "--visual_feature", "i3d",
        "--root_path", synth_root, "--q_feat_size", "12",
        "--dset_name", "synthetic", "--double_branch", "--label_style",
        "soft", "--results_root", str(tmp_path / "r"), "--bsz", "4",
        "--query_pad_multiple", "8", "--torch_device", "cpu"])
    monkeypatch.setattr(train, "process_group", lambda: "world")
    monkeypatch.setattr(train.dist, "get_world_size", lambda group: 8)
    monkeypatch.setattr(train.dist, "get_rank", lambda group: 0)
    with pytest.raises(ValueError, match="launch 4 processes"):
        train.start_training(cfg, device="cpu")


@pytest.mark.parametrize("drop_last", [True, False])
def test_drop_last_matches_jax(synth_root, drop_last):
    from dldkd_tpu_torch.data import dataset_paths, pack_train_dataset
    from dldkd_tpu_torch.data import BigFile, read_dict

    p = dataset_paths(synth_root, "synthetic", "i3d")
    data = pack_train_dataset(
        p["cap_file"]["train"], BigFile(p["visual_feat_dir"]),
        read_dict(p["video2frames"]), p["text_feat"],
        p["teacher_vid_feat"], p["teacher_text_feat"], max_ctx_l=8,
        max_desc_l=4)
    kw = dict(bsz=12, seed=3, query_pad_multiple=8, drop_last=drop_last)
    mine, theirs = TrainLoader(data, **kw), JaxTrainLoader(data, **kw)
    # 32 videos in batches of 12: two whole batches and one of 8
    assert mine.steps_per_epoch() == theirs.steps_per_epoch() == (
        2 if drop_last else 3)
    for epoch in range(2):
        pairs = list(zip(mine.epoch(epoch), theirs.epoch(epoch),
                         strict=True))
        assert len(pairs) == mine.steps_per_epoch()
        for a, b in pairs:
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
