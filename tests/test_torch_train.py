"""The port's training loop (`dldkd_tpu_torch/train.py`) on the CPU.

- Whole-run parity with `dldkd_tpu.train.start_training`: the same
  on-disk synthetic fixture (the JAX package's generator, HDF5; the JAX
  side on its numpy packer), the same initial weights (the JAX package's
  seeded init carried over by the converter), 3 epochs, dropout 0, hard
  negatives from a pool of 1. Per-step losses (every component) within
  1e-3, per-epoch fused validation SumR equal, the same best epoch, and
  the best checkpoints' step counts equal, parameters and moments within
  f32 noise (this catches a schedule fault the losses alone miss).
  Determinism recipe as in tests/test_whole_run_parity.py:12-30: hard
  negatives from epoch 0 with pool 1, distinct caption counts; for the
  hard-negative flip at epoch 1, batches of two videos with one caption
  each, so the uniform negatives of epoch 0 have one candidate. Both
  loaders shuffle alike (RandomState(seed + epoch)).
- Exact resume: with dropout on, 3 epochs straight give bitwise the same
  parameters, optimizer state and generator state as 2 epochs, then
  --resume for the third (`assert_resume_exact`, also run in bf16 with
  stacked towers by tests/test_torch_bf16_train.py).
- --dtype bfloat16 and --stacked_towers train; stacked towers without two
  branches of one hidden size raise before packing.
- Checkpoints across packages: the port's restores in
  `dldkd_tpu.checkpoint.restore_checkpoint`, and a JAX one resumes in the
  port (which re-seeds its generator and says so).
- Preemption (SIGTERM mid-epoch and during validation), the CLI, and the
  --matmul_precision mapping (fault C3).

TensorBoard is off in both packages' loops here (its import alone takes seconds);
metrics.jsonl carries every scalar.
"""

import dataclasses
import glob
import json
import logging
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dldkd_tpu import checkpoint as jax_ckpt
from dldkd_tpu import train as jax_train
from dldkd_tpu.config import Config as JaxConfig
from dldkd_tpu.data import native as jax_native
from dldkd_tpu.data.synthetic import generate_dataset as jax_generate
from dldkd_tpu.models import DLDKD as JaxDLDKD
from dldkd_tpu.optim.bert_adam import BertAdamState
from dldkd_tpu.optim.bert_adam import bert_adam as jax_bert_adam
from dldkd_tpu.optim import default_wd_mask as jax_wd_mask
from dldkd_tpu_torch import checkpoint as ckpt_lib
from dldkd_tpu_torch import evaluate, infer
from dldkd_tpu_torch import train as train_mod
from dldkd_tpu_torch.config import Config, parse_args
from dldkd_tpu_torch.convert import (opt_state_from_jax, state_dict_from_jax)
from dldkd_tpu_torch.utils import logging as port_logging

LOSS_KEYS = train_mod.LOSS_KEYS
MAX_CTX, MAX_DESC = 16, 7
D_STUDENT, D_QUERY, D_TEACHER = 20, 14, 10
HIDDEN, HEADS = 16, 2
N_EPOCH = 3
BASE = dict(
    visual_feature="i3d", q_feat_size=D_QUERY, max_ctx_l=MAX_CTX,
    max_desc_l=MAX_DESC, inheritance_hidden=HIDDEN,
    exploration_hidden=HIDDEN, n_heads=HEADS, input_drop=0.0, drop=0.0,
    double_branch=True, margin=0.1, lr=3e-4, wd=0.01,
    lr_warmup_proportion=0.01, n_epoch=N_EPOCH, max_es_cnt=10, seed=9527,
    hard_negative_start_epoch=0, hard_pool_size=1,
    distill_loss_decay="exp", alpha_decay="sigmoid", belta_decay="sigmoid",
    eval_query_bsz=50, eval_context_bsz=200, pack_cache=False)


@pytest.fixture(autouse=True, scope="module")
def _numerics_and_writers():
    mp = pytest.MonkeyPatch()
    threads = torch.get_num_threads()
    precision = torch.get_float32_matmul_precision()
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    # the JAX package on its numpy packer (the native one is an f32 ulp
    # away, fault C2), and no TensorBoard in either loop
    mp.setenv("DLDKD_NO_NATIVE", "1")
    mp.setattr(jax_native, "_lib", None)
    mp.setattr(jax_native, "_tried", False)
    for mod in (jax_train, train_mod):
        real = mod.MetricsWriter
        mp.setattr(mod, "MetricsWriter",
                   lambda log_dir, _real=real: _real(log_dir,
                                                     tensorboard=False))
    yield
    mp.undo()
    torch.set_num_threads(threads)
    torch.set_float32_matmul_precision(precision)


def _configs(root, collection, out, **over):
    """The same run as a JAX Config and a port Config (flat flag names),
    finalized under out/{jax,port}."""
    flat = dict(BASE, root_path=root, collection=collection,
                dset_name=collection, exp_id="run", **over)
    return (JaxConfig.from_flat_dict(dict(flat, results_root=f"{out}/jax")
                                     ).finalize(),
            Config.from_flat_dict(dict(flat, results_root=f"{out}/port")
                                  ).finalize())


def _jax_init(jcfg: JaxConfig, d_student: int):
    mcfg = jcfg.model.replace(visual_input_size=d_student,
                              query_input_size=jcfg.data.q_feat_size,
                              max_ctx_l=MAX_CTX, max_desc_l=MAX_DESC)
    return jax_train.init_params(JaxDLDKD(config=mcfg), mcfg,
                                 jcfg.train.seed)


def _history(cfg):
    """(per-step losses {key: [..]}, per-eval fused SumR) of a run."""
    losses = {k: {} for k in LOSS_KEYS}
    sumrs = []
    with open(os.path.join(cfg.tensorboard_log_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            for k in LOSS_KEYS:
                if f"Train/{k}" in rec:
                    losses[k][rec["step"]] = rec[f"Train/{k}"]
            if "Val/fused_sumr" in rec:
                sumrs.append(rec["Val/fused_sumr"])
    return {k: [v[s] for s in sorted(v)] for k, v in losses.items()}, sumrs


def _best_epoch(cfg) -> int:
    return int(ckpt_lib.read_checkpoint(cfg.ckpt_dir)["epoch"])


def _both_runs(root, collection, out, **over):
    jcfg, pcfg = _configs(root, collection, out, **over)
    # numpy copies first: the JAX step donates its parameter buffers
    params = jax.tree.map(np.asarray, _jax_init(jcfg, D_STUDENT))
    jax_train.start_training(jcfg, initial_params=jax.tree.map(jnp.asarray,
                                                               params))
    train_mod.start_training(pcfg, device="cpu", initial_params=params)
    return jcfg, pcfg


@pytest.fixture(scope="module")
def soft_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_soft_data"))
    jax_generate(root, collection="synthwr", visual_feature="i3d",
                 n_videos={"train": 6, "val": 16},
                 caps_sequence={"train": [8, 7, 6, 5, 4, 3]},
                 caps_per_video=(1, 3), frames_range=(6, 28),
                 teacher_frames_range=(4, 14), tokens_range=(3, MAX_DESC),
                 d_student=D_STUDENT, d_query=D_QUERY, d_teacher=D_TEACHER,
                 noise=0.5, seed=23)
    out = str(tmp_path_factory.mktemp("train_soft_runs"))
    jcfg, pcfg = _both_runs(root, "synthwr", out, label_style="soft",
                            bsz=64, query_pad_multiple=8)
    return root, jcfg, pcfg


@pytest.fixture(scope="module")
def flip_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_flip_data"))
    jax_generate(root, collection="synthflip", visual_feature="i3d",
                 n_videos={"train": 4, "val": 16},
                 caps_sequence={"train": [1] * 4}, caps_per_video=(1, 3),
                 frames_range=(14, 28), teacher_frames_range=(4, 14),
                 tokens_range=(3, MAX_DESC), d_student=D_STUDENT,
                 d_query=D_QUERY, d_teacher=D_TEACHER, noise=0.5, seed=31)
    out = str(tmp_path_factory.mktemp("train_flip_runs"))
    # two 2-video batches per epoch; query_pad_multiple 3 pads each batch's
    # 2 queries to 3 and keeps the JAX package's run on one device
    return _both_runs(root, "synthflip", out, label_style="hard", bsz=2,
                      query_pad_multiple=3, hard_negative_start_epoch=1)


def _assert_same_run(jcfg, pcfg, steps):
    j_losses, j_sumrs = _history(jcfg)
    p_losses, p_sumrs = _history(pcfg)
    for k in LOSS_KEYS:
        assert len(p_losses[k]) == len(j_losses[k]) == N_EPOCH * steps
        np.testing.assert_allclose(p_losses[k], j_losses[k], rtol=0,
                                   atol=1e-3, err_msg=k)
    assert len(p_sumrs) == len(j_sumrs) == N_EPOCH
    assert p_sumrs == j_sumrs
    assert _best_epoch(pcfg) == _best_epoch(jcfg)
    # the best checkpoints hold the same state: the step count exactly, the
    # parameters and BertAdam's moments within f32 noise (the packages'
    # differ by ~1e-7, ~7e-8 and ~6e-10 here; a fault in the loop's step
    # count or LR schedule moves the parameters by ~lr = 3e-4)
    j_ck = ckpt_lib.restore_checkpoint(jcfg.ckpt_dir)
    p_ck = ckpt_lib.restore_checkpoint(pcfg.ckpt_dir)
    assert int(p_ck["epoch"]) == int(j_ck["epoch"])
    assert int(p_ck["opt_state"]["step"]) == int(j_ck["opt_state"]["step"]) \
        == (int(j_ck["epoch"]) + 1) * steps
    for tree, atol in ((lambda c: c["params"], 1e-6),
                       (lambda c: c["opt_state"]["m"], 1e-6),
                       (lambda c: c["opt_state"]["v"], 1e-8)):
        sj, sp = state_dict_from_jax(tree(j_ck)), state_dict_from_jax(
            tree(p_ck))
        assert sp.keys() == sj.keys()
        for k in sj:
            torch.testing.assert_close(sp[k], sj[k], rtol=0, atol=atol,
                                       msg=k)
    # the run moves the model: evidence of trajectory agreement
    assert abs(j_losses["loss_overall"][0] - j_losses["loss_overall"][-1]) \
        > 1e-4
    with open(pcfg.train_log_filepath) as f:
        assert f.read().count("[Epoch]") == N_EPOCH


def test_whole_run_soft_matches_jax(soft_runs):
    _, jcfg, pcfg = soft_runs
    _assert_same_run(jcfg, pcfg, steps=1)


def test_whole_run_hard_negative_flip_matches_jax(flip_runs):
    jcfg, pcfg = flip_runs
    _assert_same_run(jcfg, pcfg, steps=2)
    with open(os.path.join(pcfg.results_dir, "performance.log")) as f:
        log = f.read()
    assert "epoch 0: kd_weight=1.0000" in log and "hard_neg=False" in log
    assert "epoch 1: kd_weight=0.9500" in log and "hard_neg=True" in log


def test_port_checkpoint_restores_in_jax(soft_runs):
    root, jcfg, pcfg = soft_runs
    params = _jax_init(jcfg, D_STUDENT)
    opt = jax_bert_adam(1e-4, None, wd_mask=jax_wd_mask(params))
    template = {"params": params, "opt_state": opt.init(params),
                "epoch": 0, "best_score": 0.0,
                "rng": jax.random.PRNGKey(0)}
    restored = jax_ckpt.restore_checkpoint(pcfg.ckpt_dir, template)
    assert isinstance(restored["opt_state"], BertAdamState)
    ours = ckpt_lib.restore_checkpoint(pcfg.ckpt_dir)
    assert int(restored["epoch"]) == int(ours["epoch"])
    assert float(restored["best_score"]) == float(ours["best_score"])
    for a, b in ((restored["params"], ours["params"]),
                 (restored["opt_state"].m, ours["opt_state"]["m"]),
                 (restored["opt_state"].v, ours["opt_state"]["v"])):
        sa, sb = state_dict_from_jax(jax.tree.map(np.asarray, a)), \
            state_dict_from_jax(b)
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    n_steps = int(ours["epoch"]) + 1     # one step per epoch here
    # the step count is a 0-d int32 array in both readers, as flax writes it
    for step in (restored["opt_state"].step, ours["opt_state"]["step"]):
        assert np.asarray(step).shape == () and int(step) == n_steps
    # the moments are live (the run trained), not the zero init
    assert any(float(np.abs(np.asarray(x)).max()) > 0
               for x in jax.tree.leaves(restored["opt_state"].m))


def test_jax_checkpoint_resumes_in_port(soft_runs, tmp_path, caplog):
    root, jcfg, _ = soft_runs
    saved = _best_epoch(jcfg)
    _, pcfg = _configs(root, "synthwr", str(tmp_path), label_style="soft",
                       bsz=64, query_pad_multiple=8, n_epoch=saved + 2,
                       resume=jcfg.ckpt_dir)
    with caplog.at_level(logging.INFO, logger="dldkd_tpu_torch"):
        train_mod.start_training(pcfg, device="cpu")
    assert "re-seeded the generator from 9528" in caplog.text
    with open(pcfg.train_log_filepath) as f:
        log = f.read()
    assert f"[Epoch] {saved + 1:03d}" in log
    assert f"[Epoch] {saved:03d}" not in log
    losses, sumrs = _history(pcfg)
    assert len(losses["loss_overall"]) == 1 and len(sumrs) == 1
    assert np.isfinite(losses["loss_overall"][0])


# ----------------------------------------------------- resume, preemption

@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_small_data"))
    jax_generate(root, collection="synthetic", visual_feature="i3d",
                 n_videos={"train": 10, "val": 6, "test": 6},
                 frames_range=(6, 28), teacher_frames_range=(4, 14),
                 tokens_range=(3, MAX_DESC), d_student=D_STUDENT,
                 d_query=D_QUERY, d_teacher=D_TEACHER, seed=5)
    return root


def _small_cfg(root, out, **over):
    return _configs(root, "synthetic", out, label_style="soft", bsz=4,
                    query_pad_multiple=8, max_es_cnt=-1, input_drop=0.2,
                    drop=0.2, hard_negative_start_epoch=1, hard_pool_size=3,
                    **over)[1]


def _stop_at_eval(monkeypatch, guard, nth):
    """SIGTERM latched while the nth validation of the run runs."""
    real = train_mod.run_retrieval_eval
    calls = []

    def eval_then_stop(*a, **kw):
        out = real(*a, **kw)
        calls.append(1)
        if len(calls) == nth:
            guard.trigger()
        return out

    monkeypatch.setattr(train_mod, "run_retrieval_eval", eval_then_stop)


def test_resume_is_exact(small_root, tmp_path, monkeypatch):
    """Dropout on, uniform negatives in epoch 0 and hard ones from a pool
    of 3 after it: 3 epochs straight against
    2 epochs (stopped after the second validation, as a SIGTERM there
    would) plus --resume for the third; the state after epoch 2 is bitwise
    the same."""
    assert_resume_exact(small_root, tmp_path, monkeypatch)


def assert_resume_exact(small_root, tmp_path, monkeypatch, **over):
    """The body of test_resume_is_exact, on `_small_cfg(**over)`."""
    from dldkd_tpu_torch.utils import PreemptionGuard

    def run(out, nth, **more):
        guard = PreemptionGuard()
        _stop_at_eval(monkeypatch, guard, nth)
        cfg = _small_cfg(small_root, out, **over, **more)
        train_mod.start_training(cfg, device="cpu", preempt_guard=guard)
        monkeypatch.undo()
        return cfg

    straight = run(str(tmp_path / "a"), 3)
    first = run(str(tmp_path / "b"), 2)
    state = ckpt_lib.read_checkpoint(first.ckpt_dir + "_preempt")
    assert int(state["epoch"]) == 1
    resumed = run(str(tmp_path / "c"), 1, resume=first.ckpt_dir + "_preempt")
    a = ckpt_lib.read_checkpoint(straight.ckpt_dir + "_preempt")
    b = ckpt_lib.read_checkpoint(resumed.ckpt_dir + "_preempt")
    assert int(a["epoch"]) == int(b["epoch"]) == 2
    sa, sb = state_dict_from_jax(a["params"]), state_dict_from_jax(b["params"])
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = opt_state_from_jax(a["opt_state"]), \
        opt_state_from_jax(b["opt_state"])
    assert oa["step"] == ob["step"] == 9     # 3 steps per epoch
    for key in ("m", "v"):
        for k in oa[key]:
            assert torch.equal(oa[key][k], ob[key][k]), (key, k)
    np.testing.assert_array_equal(a["rng"], b["rng"])
    assert a["rng"].dtype == np.uint8
    with open(resumed.train_log_filepath) as f:
        log = f.read()
    assert "[Epoch] 002" in log and "[Epoch] 001" not in log
    return straight


def test_sigterm_mid_epoch_checkpoints_and_resumes(small_root, tmp_path,
                                                   monkeypatch):
    """A real SIGTERM during epoch 1's first step: the epoch's losses are
    flushed, <ckpt>_preempt records epoch 0 as the last one done, and the
    CLI skips the post-train inference; --resume replays epoch 1."""
    real_step = train_mod.train_step
    steps = []

    def step_then_sigterm(*a, **kw):
        out = real_step(*a, **kw)
        steps.append(1)
        if len(steps) == 4:          # the first step of epoch 1
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    monkeypatch.setattr(train_mod, "train_step", step_then_sigterm)
    out = str(tmp_path / "p")
    args = ["--collection", "synthetic", "--visual_feature", "i3d",
            "--root_path", small_root, "--q_feat_size", str(D_QUERY),
            "--results_root", out, "--bsz", "4", "--n_epoch", "3",
            "--max_ctx_l", str(MAX_CTX), "--max_desc_l", str(MAX_DESC),
            "--inheritance_hidden", str(HIDDEN), "--exploration_hidden",
            str(HIDDEN), "--n_heads", str(HEADS), "--query_pad_multiple", "8",
            "--double_branch", "--label_style", "soft",
            "--torch_device", "cpu"]
    prev = signal.getsignal(signal.SIGTERM)
    assert train_mod.main(args) is None
    assert signal.getsignal(signal.SIGTERM) == prev
    run_dir = glob.glob(os.path.join(out, "*", "*-*"))[0]
    assert not os.path.exists(os.path.join(run_dir, "eval.log.txt"))
    state = ckpt_lib.read_checkpoint(os.path.join(run_dir, "ckpt_preempt"))
    assert int(state["epoch"]) == 0
    with open(os.path.join(run_dir, "train.log.txt")) as f:
        log = f.read()
    assert "[Epoch] 001" in log and "[Epoch] 002" not in log
    with open(os.path.join(run_dir, "performance.log")) as f:
        assert "preempted at epoch 1 step 4" in f.read()

    monkeypatch.undo()
    cfg = parse_args(args[:-2] + ["--results_root", str(tmp_path / "r"),
                                  "--resume",
                                  os.path.join(run_dir, "ckpt_preempt")])
    train_mod.start_training(cfg, device="cpu")
    with open(cfg.train_log_filepath) as f:
        log = f.read()
    assert "[Epoch] 000" not in log
    assert "[Epoch] 001" in log and "[Epoch] 002" in log


@pytest.mark.parametrize("debug", [True, False])
def test_cli_writes_the_run(small_root, tmp_path, debug):
    """--debug (with --profile_dir): a few steps of one epoch and its
    validation, no test inference. Without it (and --eval_untrained):
    the untrained validation, one epoch, then the test-split
    inference."""
    out = str(tmp_path / "results")
    args = ["--collection", "synthetic", "--visual_feature", "i3d",
            "--root_path", small_root, "--q_feat_size", str(D_QUERY),
            "--results_root", out, "--bsz", "4", "--n_epoch", "1",
            "--max_ctx_l", str(MAX_CTX), "--max_desc_l", str(MAX_DESC),
            "--inheritance_hidden", str(HIDDEN), "--exploration_hidden",
            str(HIDDEN), "--n_heads", str(HEADS), "--query_pad_multiple", "8",
            "--double_branch", "--label_style", "soft",
            "--torch_device", "cpu"] + (
                ["--debug", "--profile_dir", str(tmp_path / "prof"),
                 "--profile_steps", "1"] if debug else ["--eval_untrained"])
    metrics = train_mod.main(args)
    base = os.path.join(tmp_path, "debug_results") if debug else out
    run_dir = glob.glob(os.path.join(base, "*", "*-*"))[0]
    for rel in ("train.log.txt", "tensorboard_log/metrics.jsonl",
                "code.zip", "opt.json", "ckpt/model.ckpt",
                "ckpt/model_cfg.json", "performance.log"):
        assert os.path.isfile(os.path.join(run_dir, rel)), rel
    with open(os.path.join(run_dir, "opt.json")) as f:
        assert json.load(f)["torch_device"] == "cpu"
    import zipfile
    names = zipfile.ZipFile(os.path.join(run_dir, "code.zip")).namelist()
    assert "code/train.py" in names and "code/ops/losses.py" in names
    assert not any(n.endswith((".so", ".pyc")) for n in names)
    with open(os.path.join(run_dir, "tensorboard_log", "metrics.jsonl")) as f:
        recs = [json.loads(x) for x in f]
    assert sum("Val/fused_sumr" in r for r in recs) == (1 if debug else 2)
    assert sum("Train/loss_overall" in r for r in recs) == 3
    assert all(np.isfinite(r["Train/loss_overall"]) for r in recs
               if "Train/loss_overall" in r)
    if debug:
        assert metrics is None
        assert not os.path.exists(os.path.join(run_dir, "eval.log.txt"))
        # --profile_dir traced step 1 of the first epoch
        with open(tmp_path / "prof" / "trace.json") as f:
            assert json.load(f)["traceEvents"]
    else:
        assert set(metrics) == {"inher", "explore", "fused"}
        with open(os.path.join(run_dir, "eval.log.txt")) as f:
            assert "test fused" in f.read()


# ------------------------------------------------ C3 and small repairs

@pytest.mark.parametrize("setting,expect", [("highest", "highest"),
                                            ("high", "high"),
                                            ("default", "medium")])
def test_matmul_precision_applies_in_training_and_inference(
        small_root, tmp_path, monkeypatch, setting, expect):
    seen = []
    real_step = train_mod.train_step
    real_eval = infer.run_retrieval_eval

    def step(*a, **kw):
        seen.append(("train", torch.get_float32_matmul_precision()))
        return real_step(*a, **kw)

    def ev(*a, **kw):
        seen.append(("infer", torch.get_float32_matmul_precision()))
        return real_eval(*a, **kw)

    monkeypatch.setattr(train_mod, "train_step", step)
    monkeypatch.setattr(infer, "run_retrieval_eval", ev)
    cfg = _small_cfg(small_root, str(tmp_path), n_epoch=1,
                     matmul_precision=setting)
    before = torch.get_float32_matmul_precision()
    train_mod.start_training(cfg, device="cpu")
    assert torch.get_float32_matmul_precision() == before
    test_cfg = dataclasses.replace(
        cfg, eval=dataclasses.replace(cfg.eval, model_dir=cfg.results_dir))
    infer.start_inference(test_cfg, device="cpu")
    assert torch.get_float32_matmul_precision() == before
    assert {p for _, p in seen} == {expect}
    assert {w for w, _ in seen} == {"train", "infer"}


def test_debug_nans_turns_on_anomaly_detection(small_root, tmp_path,
                                               monkeypatch):
    seen = []
    real_step = train_mod.train_step

    def step(*a, **kw):
        seen.append(torch.is_anomaly_enabled())
        return real_step(*a, **kw)

    monkeypatch.setattr(train_mod, "train_step", step)
    for flag in (True, False):
        cfg = _small_cfg(small_root, str(tmp_path / str(flag)), n_epoch=1,
                         debug_nans=flag)
        train_mod.start_training(cfg, device="cpu")
        assert set(seen) == {flag} and not torch.is_anomaly_enabled()
        seen.clear()


def test_untrainable_flags_raise_before_packing(small_root, tmp_path):
    """--dtype bfloat16 and --stacked_towers train (one epoch on the small
    fixture); --stacked_towers without two branches of one hidden size
    raises ValueError before any data is packed (the root does not
    exist)."""
    cfg = _small_cfg(small_root, str(tmp_path / "ok"), n_epoch=1,
                     dtype="bfloat16", stacked_towers=True)
    train_mod.start_training(cfg, device="cpu")
    assert os.path.isfile(os.path.join(cfg.ckpt_dir, "model.ckpt"))
    for extra in (["--stacked_towers"],
                  ["--stacked_towers", "--double_branch",
                   "--exploration_hidden", "32", "--dtype", "bfloat16"]):
        cfg = parse_args(["--root_path", str(tmp_path / "nowhere"),
                          "--results_root", str(tmp_path / "r")] + extra)
        with pytest.raises(ValueError, match="stacked"):
            train_mod.start_training(cfg, device="cpu")


def test_run_retrieval_eval_guards_eval_mode(soft_runs):
    """Validation on a module in training mode (with dropout on) gives the
    eval-mode metrics, and hands the module back in training mode."""
    root, _, pcfg = soft_runs
    mcfg, _, videos, queries, _ = train_mod.build_model_and_data(pcfg)
    model = train_mod.init_params(mcfg.replace(input_drop=0.3, drop=0.3), 1)
    ref = evaluate.run_retrieval_eval(model.eval(), videos, queries,
                                      pcfg.eval, device="cpu")
    model.train()
    got = evaluate.run_retrieval_eval(model, videos, queries, pcfg.eval,
                                      device="cpu")
    assert got == ref and model.training


def test_setup_logging_keeps_one_file_handler(tmp_path):
    for i in range(3):
        logger = port_logging.setup_logging(str(tmp_path / f"run{i}"))
    files = [h for h in logger.handlers if isinstance(h, logging.FileHandler)]
    assert len(files) == 1 and files[0].baseFilename.endswith(
        os.path.join("run2", "performance.log"))
    port_logging.setup_logging(None)
