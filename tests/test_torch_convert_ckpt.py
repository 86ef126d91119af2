"""The port's released-checkpoint converter against the JAX package's.

`dldkd_tpu_torch.convert.convert_torch_checkpoint` (and `python -m
dldkd_tpu_torch.convert`) reads the reference's model.ckpt, the pickle
{"model": state_dict, "model_cfg": EasyDict, "epoch"}, and writes the
checkpoint directory `dldkd_tpu.convert.convert_torch_checkpoint` writes.
The pickles here hold a seeded JAX init carried into the reference's names
by `dldkd_tpu.convert.flax_to_torch_state_dict` (as tests/test_convert.py
makes them): two branches and one, names with and without DataParallel's
`module.` prefix, model_cfg as a dict, empty, and as a pickled EasyDict.

Held: model_cfg.json equal as dicts; every parameter bitwise equal when
both model.ckpt files are read with `dldkd_tpu_torch.checkpoint.
read_msgpack`, and the files themselves byte for byte; the epoch; the
state-dict mapping against `torch_state_dict_to_flax`; the CLI in a fresh
process, which must import neither JAX nor easydict (the port's own
EasyDict stand-in unpickles the config); and the converted directories
evaluated by both packages' infer with equal metric dicts (the tolerance of
tests/test_torch_eval.py).
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dldkd_tpu import convert as jax_convert
from dldkd_tpu import infer as jax_infer
from dldkd_tpu.config import Config as JaxConfig
from dldkd_tpu.config import ModelConfig as JaxModelConfig
from dldkd_tpu.config import parse_args as jax_parse_args
from dldkd_tpu.data.synthetic import generate_dataset as jax_generate
from dldkd_tpu.models import DLDKD as JaxDLDKD
from dldkd_tpu.train import init_params
from dldkd_tpu_torch import convert, infer
from dldkd_tpu_torch.checkpoint import CFG_NAME, CKPT_NAME, read_msgpack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = dict(visual_input_size=20, query_input_size=12, inheritance_hidden=16,
            exploration_hidden=16, max_ctx_l=10, max_desc_l=6, n_heads=2)
EPOCH = 7
# the reference's model_cfg keys that the converters read (train.py:300-314)
SAVED_CFG = {"max_ctx_l": 10, "max_desc_l": 6, "n_heads": 2, "drop": 0.25,
             "input_drop": 0.15, "margin": 0.1, "hard_pool_size": 5,
             "visual_input_size": 20, "query_input_size": 12}


@pytest.fixture(autouse=True, scope="module")
def _torch_numerics():
    threads = torch.get_num_threads()
    precision = torch.get_float32_matmul_precision()
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(threads)
    torch.set_float32_matmul_precision(precision)


def _easydict(values):
    """An easydict.EasyDict as the reference pickles it; the port's
    stand-in provides the class where easydict is not installed."""
    convert._ensure_fake_easydict()
    return sys.modules["easydict"].EasyDict(values)


@pytest.fixture(scope="module")
def jax_params():
    """{double: a seeded JAX init (numpy leaves)}."""
    out = {}
    for double in (True, False):
        mcfg = JaxModelConfig(double_branch=double, **DIMS)
        out[double] = jax.tree.map(
            np.asarray, init_params(JaxDLDKD(config=mcfg), mcfg, 3 + double))
    return out


def _reference_ckpt(path, params, prefix, model_cfg):
    sd = {prefix + k: torch.from_numpy(np.array(v))
          for k, v in jax_convert.flax_to_torch_state_dict(params).items()}
    torch.save({"model": sd, "model_cfg": model_cfg, "epoch": EPOCH}, path)
    return path


def _model_cfg(kind):
    return {"dict": dict(SAVED_CFG), "empty": {},
            "easydict": _easydict(SAVED_CFG)}[kind]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _assert_same_dir(got_dir, want_dir):
    with open(os.path.join(got_dir, CFG_NAME)) as f:
        got_cfg = json.load(f)
    with open(os.path.join(want_dir, CFG_NAME)) as f:
        want_cfg = json.load(f)
    assert got_cfg == want_cfg
    got = read_msgpack(os.path.join(got_dir, CKPT_NAME))
    want = read_msgpack(os.path.join(want_dir, CKPT_NAME))
    assert int(got["epoch"]) == int(want["epoch"]) == EPOCH
    g, w = dict(_leaves(got["params"])), dict(_leaves(want["params"]))
    assert g.keys() == w.keys() and len(g) > 20
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=str(k))
    with open(os.path.join(got_dir, CKPT_NAME), "rb") as f, \
            open(os.path.join(want_dir, CKPT_NAME), "rb") as h:
        assert f.read() == h.read()
    return got_cfg


@pytest.mark.parametrize("cfg_kind", ["dict", "empty", "easydict"])
@pytest.mark.parametrize("prefix", ["", "module."], ids=["plain", "module"])
@pytest.mark.parametrize("double", [True, False], ids=["double", "single"])
def test_converter_matches_jax(jax_params, tmp_path, double, prefix,
                               cfg_kind):
    path = _reference_ckpt(str(tmp_path / "model.ckpt"), jax_params[double],
                           prefix, _model_cfg(cfg_kind))
    want_dir = jax_convert.convert_torch_checkpoint(
        path, str(tmp_path / "jax"), label_style="soft")
    got_dir = convert.convert_torch_checkpoint(path, str(tmp_path / "port"),
                                               label_style="soft")
    cfg = _assert_same_dir(got_dir, want_dir)
    assert cfg["double_branch"] is double and cfg["label_style"] == "soft"
    # the saved config wins; the shapes and the defaults fill its gaps
    assert cfg["inheritance_hidden"] == 16 and cfg["max_ctx_l"] == 10
    assert cfg["n_heads"] == (4 if cfg_kind == "empty" else 2)
    assert cfg["drop"] == (0.1 if cfg_kind == "empty" else 0.25)


@pytest.mark.parametrize("double", [True, False], ids=["double", "single"])
def test_state_dict_mapping_matches_jax(jax_params, double):
    """The port's mapping of the reference's names (params_from_state_dict)
    against dldkd_tpu.convert.torch_state_dict_to_flax, bitwise."""
    sd = jax_convert.flax_to_torch_state_dict(jax_params[double])
    want = jax_convert.torch_state_dict_to_flax(sd, double)
    got = convert.params_from_state_dict(
        {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()})
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=str(k))


def test_cli_in_fresh_process(jax_params, tmp_path):
    """`python -m dldkd_tpu_torch.convert` on a module.-prefixed pickle
    with an EasyDict config writes the same bytes as the in-process
    converter, and imports neither JAX nor the JAX package nor easydict
    (`-X importtime` lists every import of the process)."""
    path = _reference_ckpt(str(tmp_path / "model.ckpt"), jax_params[True],
                           "module.", _easydict(SAVED_CFG))
    want_dir = convert.convert_torch_checkpoint(path, str(tmp_path / "in"))
    out_dir = str(tmp_path / "cli")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "dldkd_tpu_torch.convert",
         "--torch_ckpt", path, "--out_dir", out_dir],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert f"wrote {out_dir}" in proc.stdout
    imported = {line.rsplit("|", 1)[-1].strip().split(".")[0]
                for line in proc.stderr.splitlines()
                if line.startswith("import time:")}
    assert "torch" in imported
    assert not imported & {"jax", "jaxlib", "flax", "dldkd_tpu", "easydict"}
    _assert_same_dir(out_dir, want_dir)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("convert_eval_data"))
    jax_generate(root, n_videos={"train": 2, "val": 4, "test": 12},
                 frames_range=(5, 16), teacher_frames_range=(4, 8),
                 tokens_range=(3, 6), d_student=DIMS["visual_input_size"],
                 d_query=DIMS["query_input_size"], d_teacher=8, noise=0.3,
                 seed=11)
    return root


@pytest.mark.parametrize("double", [True, False], ids=["double", "single"])
def test_converted_checkpoint_evaluates_as_in_jax(jax_params, dataset,
                                                  tmp_path, double):
    """<run>/ckpt from each converter, the run's opt.json in <run>/ (the
    documented recipe): the port's infer.main on the CPU and
    dldkd_tpu.infer give equal metric dicts."""
    path = _reference_ckpt(str(tmp_path / "model.ckpt"), jax_params[double],
                           "module.", _easydict(SAVED_CFG))
    base = JaxConfig()
    opt = dataclasses.replace(
        base, data=dataclasses.replace(
            base.data, root_path=dataset, collection="synthetic",
            visual_feature="i3d", q_feat_size=DIMS["query_input_size"]),
        eval=dataclasses.replace(base.eval, eval_query_bsz=5,
                                 eval_context_bsz=4))
    runs = {}
    for name, conv in (("jax", jax_convert), ("port", convert)):
        run = str(tmp_path / f"run_{name}")
        conv.convert_torch_checkpoint(path, os.path.join(run, "ckpt"))
        opt.save(os.path.join(run, "opt.json"))
        runs[name] = run
    argv = ["--root_path", dataset, "--no_pack_cache"]
    want = jax_infer.start_inference(jax_parse_args(
        ["--model_dir", runs["jax"]] + argv, test=True, finalize=False))
    got = infer.main(["--model_dir", runs["port"], "--torch_device",
                      "cpu"] + argv)
    assert got == want
    assert all(np.isfinite(v) for m in got.values() for v in m.values())
    with open(os.path.join(runs["port"], "eval.log.txt")) as f:
        assert "test fused: r_1_5_10_100" in f.read()
