"""The port's entry scripts (`scripts/torch/do_*.sh`) against the JAX
package's (`scripts/do_*.sh`).

- Each port script is its twin line for line outside comments, with
  `dldkd_tpu.` -> `dldkd_tpu_torch.` the only change: the same flags,
  hyperparameters and "${@:2}" / "${@:5}" pass-through.
- ActivityNet and Charades end to end at their query width of 1,024, on
  the fixture of tests/test_scripts_e2e.py: the port's training script and
  then its do_test.sh, each in a fresh process with `--torch_device cpu`;
  the JAX side runs the argv its own scripts hand to `python` (recorded by
  a stand-in `python` on PATH), in this process. Both start from one
  seeded JAX init, given as a `--resume` checkpoint at epoch -1, with the
  determinism recipe of tests/test_torch_train.py as trailing overrides:
  dropout 0, hard negatives from epoch 0 with a pool of 1, distinct
  caption counts in the train split, and a query pad multiple of 3, which
  keeps the JAX run on one device (its data-parallel mesh needs the batch
  and the pad multiple to divide the device count). Held: per-step losses
  within 1e-3 and per-epoch validation fused SumR equal, the same best
  epoch, opt.json equal apart from paths and torch_device, and do_test.sh's
  test metrics (eval.log.txt) equal.
- Charades trains on `i3d_rgb_lgi`, and do_test.sh is given `i3d`; the
  restored opt.json's feature wins in both packages (visual_feature is not
  in the test-time allowlist). The two feature directories hold different
  data (another seed), so the metrics show which one was read.

The port's processes run with TensorFlow hidden (a sitecustomize on
PYTHONPATH): TensorBoard then writes its events without it, instead of
spending ~15 s importing it. One thread each.
"""

import dataclasses
import glob
import json
import os
import stat
import subprocess
import sys

import jax
import numpy as np
import pytest

from dldkd_tpu import infer as jax_infer
from dldkd_tpu import train as jax_train
from dldkd_tpu.config import ModelConfig as JaxModelConfig
from dldkd_tpu.data import native as jax_native
from dldkd_tpu.data.synthetic import generate_dataset as jax_generate
from dldkd_tpu.models import DLDKD as JaxDLDKD
from dldkd_tpu_torch import checkpoint as ckpt_lib
from dldkd_tpu_torch import infer
from dldkd_tpu_torch.config import ModelConfig, parse_args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ("do_tvr.sh", "do_activitynet.sh", "do_charades.sh", "do_test.sh")
D_STUDENT, D_QUERY, D_TEACHER = 32, 1024, 10
HIDDEN, HEADS, MAX_CTX, MAX_DESC = 16, 2, 8, 5
SEED = 9527
# tests/test_scripts_e2e.py's run, with the pad multiple that keeps the
# JAX package's run on one device
OVERRIDES = [
    "--n_epoch", "2", "--bsz", "4",
    "--inheritance_hidden", str(HIDDEN), "--exploration_hidden", str(HIDDEN),
    "--n_heads", str(HEADS), "--max_ctx_l", str(MAX_CTX),
    "--max_desc_l", str(MAX_DESC),
    "--eval_query_bsz", "16", "--eval_context_bsz", "8",
    "--query_pad_multiple", "3",
]
# the determinism recipe of tests/test_torch_train.py:3-16
DETERMINISM = ["--drop", "0", "--input_drop", "0",
               "--hard_negative_start_epoch", "0", "--hard_pool_size", "1"]


def _code_lines(path):
    with open(path) as f:
        return [line.rstrip("\n") for line in f
                if not line.lstrip().startswith("#")]


@pytest.mark.parametrize("script", SCRIPTS)
def test_port_script_is_its_twin(script):
    port = os.path.join(REPO, "scripts", "torch", script)
    twin = _code_lines(os.path.join(REPO, "scripts", script))
    got = _code_lines(port)
    assert got == [line.replace("dldkd_tpu.", "dldkd_tpu_torch.")
                   for line in twin]
    changed = [a for a, b in zip(got, twin) if a != b]
    assert len(changed) == 1 and "python -m dldkd_tpu_torch." in changed[0]
    assert "--torch_device" not in "\n".join(got)
    assert os.stat(port).st_mode & stat.S_IXUSR


@pytest.fixture(autouse=True, scope="module")
def _jax_side():
    """The JAX package on its numpy packer (as the port's processes), no
    TensorBoard and no persistent compilation cache."""
    mp = pytest.MonkeyPatch()
    mp.setenv("DLDKD_NO_NATIVE", "1")
    mp.setenv("DLDKD_NO_COMPILE_CACHE", "1")
    mp.setattr(jax_native, "_lib", None)
    mp.setattr(jax_native, "_tried", False)
    real = jax_train.MetricsWriter
    mp.setattr(jax_train, "MetricsWriter",
               lambda log_dir: real(log_dir, tensorboard=False))
    yield
    mp.undo()


def _port_env(tmp_path):
    site = tmp_path / "site"
    site.mkdir(exist_ok=True)
    (site / "sitecustomize.py").write_text(
        "import sys\nsys.modules['tensorflow'] = None\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(site), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1", DLDKD_NO_NATIVE="1",
               DLDKD_PACK_CACHE_DIR=str(tmp_path / "port_packs"),
               CUDA_VISIBLE_DEVICES="")
    return env


def _run_port(script, args, env):
    proc = subprocess.run(
        ["bash", os.path.join(REPO, "scripts", "torch", script)] + args,
        capture_output=True, text=True, timeout=600, cwd=REPO, env=env)
    assert proc.returncode == 0, (
        f"{script} failed:\n{proc.stdout[-1500:]}\n{proc.stderr[-3000:]}")


def _jax_argv(script, args, tmp_path):
    """The argv scripts/<script> hands to `python`, recorded by a stand-in
    `python` first on PATH: (module, its arguments)."""
    bindir = tmp_path / "argv_recorder"
    bindir.mkdir(exist_ok=True)
    rec = bindir / "python"
    rec.write_text(f"#!{sys.executable}\nimport json, sys\n"
                   "print(json.dumps(sys.argv[1:]))\n")
    rec.chmod(0o755)
    env = dict(os.environ, PATH=f"{bindir}:{os.environ['PATH']}")
    out = subprocess.run(["bash", os.path.join(REPO, "scripts", script)]
                         + args, capture_output=True, text=True, timeout=60,
                         cwd=REPO, env=env, check=True)
    argv = json.loads(out.stdout)
    assert argv[0] == "-m"
    return argv[1], argv[2:]


def _seed_checkpoint(path):
    """A seeded JAX init as a training state at epoch -1 (fresh moments,
    step 0, the run's own first rng key): --resume starts epoch 0 from it
    in both packages."""
    mcfg = JaxModelConfig(visual_input_size=D_STUDENT,
                          query_input_size=D_QUERY, inheritance_hidden=HIDDEN,
                          exploration_hidden=HIDDEN, max_ctx_l=MAX_CTX,
                          max_desc_l=MAX_DESC, n_heads=HEADS,
                          double_branch=True)
    params = jax.tree.map(np.asarray, jax_train.init_params(
        JaxDLDKD(config=mcfg), mcfg, SEED))
    zeros = jax.tree.map(np.zeros_like, params)
    ckpt_lib.save_checkpoint(path, {
        "params": params,
        "opt_state": {"step": np.asarray(0, np.int32), "m": zeros,
                      "v": jax.tree.map(np.zeros_like, params)},
        "epoch": -1, "best_score": 0.0,
        "rng": np.asarray(jax_train.make_train_rng(SEED + 1))},
        ModelConfig(**dataclasses.asdict(mcfg)))
    return path


def _run_dir(results_root):
    opts = glob.glob(os.path.join(results_root, "**", "opt.json"),
                     recursive=True)
    assert len(opts) == 1, opts
    return os.path.dirname(opts[0])


def _history(run_dir):
    with open(os.path.join(run_dir, "tensorboard_log", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r["Train/loss_overall"] for r in recs
              if "Train/loss_overall" in r]
    sumrs = [r["Val/fused_sumr"] for r in recs if "Val/fused_sumr" in r]
    return losses, sumrs


def _eval_blocks(run_dir):
    """eval.log.txt's blocks (timestamp line dropped): one per inference."""
    with open(os.path.join(run_dir, "eval.log.txt")) as f:
        lines = f.read().splitlines()
    blocks = []
    for line in lines:
        if line.startswith("test "):
            blocks[-1].append(line)
        else:
            blocks.append([])
    return blocks


def _opt(run_dir, results_root):
    with open(os.path.join(run_dir, "opt.json")) as f:
        opt = json.load(f)
    opt.pop("torch_device", None)
    return {k: v for k, v in opt.items()
            if not (isinstance(v, str) and v.startswith(results_root))}


@pytest.mark.parametrize("script,collection,train_feat,eval_feat", [
    ("do_activitynet.sh", "activitynet", "i3d", "i3d"),
    ("do_charades.sh", "charades", "i3d_rgb_lgi", "i3d"),
])
def test_dataset_script_matches_jax(tmp_path, script, collection,
                                    train_feat, eval_feat):
    root = str(tmp_path / "root")
    kw = dict(n_videos={"train": 6, "val": 6, "test": 6},
              caps_sequence={"train": [6, 5, 4, 3, 2, 1]},
              frames_range=(8, 16), teacher_frames_range=(4, 8),
              tokens_range=(3, 5), d_student=D_STUDENT, d_query=D_QUERY,
              d_teacher=D_TEACHER)
    if eval_feat != train_feat:
        # the eval feature's directory from another seed, first: the text
        # files are then the training feature's run's
        jax_generate(root, collection=collection, visual_feature=eval_feat,
                     seed=8, **kw)
    jax_generate(root, collection=collection, visual_feature=train_feat,
                 seed=7, **kw)
    seed_ckpt = _seed_checkpoint(str(tmp_path / "seed_ckpt"))
    tail = OVERRIDES + DETERMINISM + ["--resume", seed_ckpt]
    results = {"jax": str(tmp_path / "jax_results"),
               "port": str(tmp_path / "port_results")}

    # the port: the training script, then do_test.sh, in fresh processes
    env = _port_env(tmp_path)
    _run_port(script, [root] + tail + ["--results_root", results["port"],
                                       "--torch_device", "cpu"], env)
    port_dir = _run_dir(results["port"])
    _run_port("do_test.sh", [collection, eval_feat, root, port_dir,
                             "--torch_device", "cpu"], env)

    # the JAX package: its scripts' argv, in this process
    module, argv = _jax_argv(script, [root] + tail + [
        "--results_root", results["jax"]], tmp_path)
    assert module == "dldkd_tpu.train"
    jax_train.main(argv)
    jax_dir = _run_dir(results["jax"])
    module, argv = _jax_argv("do_test.sh",
                             [collection, eval_feat, root, jax_dir], tmp_path)
    assert module == "dldkd_tpu.infer"
    jax_infer.main(argv)

    # the script's flags in the saved run config, the same in both
    opt = _opt(port_dir, results["port"])
    assert opt == _opt(jax_dir, results["jax"])
    assert opt["collection"] == collection and opt["q_feat_size"] == 1024
    assert opt["visual_feature"] == train_feat
    assert opt["label_style"] == "soft" and opt["double_branch"] is True
    assert opt["distill_loss_decay"] == "exp"
    assert opt["lr"] == pytest.approx(0.00024 if collection == "charades"
                                      else 0.00025)

    # the same training: losses, per-epoch fused SumR, best epoch
    p_losses, p_sumrs = _history(port_dir)
    j_losses, j_sumrs = _history(jax_dir)
    assert len(p_losses) == len(j_losses) == 2 * 2
    assert all(np.isfinite(p_losses))
    np.testing.assert_allclose(p_losses, j_losses, rtol=0, atol=1e-3)
    assert abs(p_losses[0] - p_losses[-1]) > 1e-4     # the run moved
    assert len(p_sumrs) == 2 and p_sumrs == j_sumrs
    assert all(0 <= s <= 400 for s in p_sumrs)
    epochs = [int(ckpt_lib.read_checkpoint(os.path.join(d, "ckpt"))["epoch"])
              for d in (port_dir, jax_dir)]
    assert epochs[0] == epochs[1]

    # eval.log.txt: the post-train test inference, then do_test.sh's
    p_blocks, j_blocks = _eval_blocks(port_dir), _eval_blocks(jax_dir)
    assert len(p_blocks) == len(j_blocks) == 2
    assert p_blocks == j_blocks
    assert len(p_blocks[1]) == 3 and p_blocks[1][2].startswith("test fused")
    # do_test.sh read the feature of the restored opt.json: the training
    # run's own test metrics, not those of the other directory
    assert p_blocks[1] == p_blocks[0]
    if eval_feat != train_feat:
        cfg = parse_args(["--model_dir", port_dir, "--root_path", root,
                          "--no_pack_cache"], test=True, finalize=False)
        assert cfg.data.visual_feature == train_feat
        other = infer.start_inference(dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data,
                                          visual_feature=eval_feat)),
            device="cpu")
        read = infer.start_inference(cfg, device="cpu")
        assert other != read
