"""The port's eval path against the JAX package on the `data/synthetic.py`
fixture: packing, the resident engine's score matrices and metric dicts
(f32, so ranks agree exactly), and the do_test.sh entry point reading a
checkpoint and an opt.json that the JAX package wrote.

Tolerances: score matrices 2e-5 abs (f32; the same operations, sums taken
in another order); packed frames 1e-7 abs (one f32 ulp of a unit row, the
JAX package's native packer against the numpy path). Metric dicts must be
equal.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dldkd_tpu import checkpoint as jax_ckpt
from dldkd_tpu import evaluate as jax_eval
from dldkd_tpu.config import Config as JaxConfig
from dldkd_tpu.config import ModelConfig as JaxModelConfig
from dldkd_tpu.data import ingest as jax_ingest
from dldkd_tpu.data.bigfile import BigFile as JaxBigFile
from dldkd_tpu.data.synthetic import generate_dataset as jax_generate
from dldkd_tpu.models import DLDKD as JaxDLDKD
from dldkd_tpu.train import init_params
from dldkd_tpu_torch import evaluate, infer
from dldkd_tpu_torch.config import EvalConfig, ModelConfig, parse_args
from dldkd_tpu_torch.convert import load_jax_params
from dldkd_tpu_torch.data import (BigFile, dataset_paths, pack_query_set,
                                  pack_video_corpus, read_dict,
                                  read_video_ids)
from dldkd_tpu_torch.data.ingest import open_features
from dldkd_tpu_torch.data.synthetic import generate_dataset
from dldkd_tpu_torch.models import DLDKD

F32_TOL = 2e-5
_DIMS = dict(visual_input_size=64, query_input_size=48, inheritance_hidden=32,
             exploration_hidden=32, max_ctx_l=16, max_desc_l=12, n_heads=4)


@pytest.fixture(autouse=True, scope="module")
def _torch_numerics():
    threads = torch.get_num_threads()
    precision = torch.get_float32_matmul_precision()
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(threads)
    torch.set_float32_matmul_precision(precision)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth_port_eval"))
    jax_generate(root, n_videos={"train": 2, "val": 14, "test": 10},
                 frames_range=(5, 30), teacher_frames_range=(4, 12),
                 d_student=64, d_query=48, d_teacher=8, noise=0.3, seed=3)
    paths = dataset_paths(root, "synthetic", "i3d")
    videos = pack_video_corpus(read_video_ids(paths["cap_file"]["val"]),
                               BigFile(paths["visual_feat_dir"]),
                               read_dict(paths["video2frames"]),
                               max_ctx_l=16)
    queries = pack_query_set(paths["cap_file"]["val"], paths["text_feat"],
                             max_desc_l=12)
    return root, paths, videos, queries


def _models(double: bool, seed: int = 0):
    jcfg = JaxModelConfig(double_branch=double, **_DIMS)
    jmodel = JaxDLDKD(config=jcfg)
    params = init_params(jmodel, jcfg, seed)
    model = load_jax_params(DLDKD(ModelConfig(double_branch=double, **_DIMS)),
                            jax.tree.map(np.asarray, params)).eval()
    return jmodel, params, model


def _eval_cfg(**kw):
    """The resident route at the JAX runs' batches (its query block floored
    at RESIDENT_QUERY_BSZ by the router)."""
    return EvalConfig(eval_query_bsz=7, eval_context_bsz=4,
                      corpus_stream_bsz=-1, **kw)


def _metrics(scores, videos, queries):
    """The eval's metric tail on score matrices the test made at explicit
    block sizes."""
    return evaluate._metrics_from_score_matrices(
        *scores, evaluate._gt_on_device(queries, videos, "cpu"), (0.7, 0.3))


def test_packing_matches_jax(dataset):
    _, paths, videos, queries = dataset
    jv = jax_ingest.pack_video_corpus(
        jax_ingest.read_video_ids(paths["cap_file"]["val"]),
        JaxBigFile(paths["visual_feat_dir"]),
        jax_ingest.read_dict(paths["video2frames"]), max_ctx_l=16)
    jq = jax_ingest.pack_query_set(paths["cap_file"]["val"],
                                   paths["text_feat"], max_desc_l=12)
    # the JAX package packs the corpus with its native C++ packer when it
    # is built, the port with the numpy path: one f32 ulp apart
    np.testing.assert_allclose(videos.feats, jv.feats, atol=1e-7, rtol=0)
    np.testing.assert_array_equal(videos.mask, jv.mask)
    assert videos.ids == jv.ids
    np.testing.assert_array_equal(queries.feats, jq.feats)
    np.testing.assert_array_equal(queries.mask, jq.mask)
    assert (queries.cap_ids, queries.video_ids) == (jq.cap_ids, jq.video_ids)


def test_generator_matches_jax(tmp_path):
    """The port's copy of the synthetic generator writes the same files as
    the JAX package's for the same arguments and seed."""
    kw = dict(n_videos={"train": 2, "test": 3}, d_student=8, d_query=6,
              d_teacher=4, seed=3)
    ours = generate_dataset(str(tmp_path / "port"), **kw)
    theirs = jax_generate(str(tmp_path / "jax"), **kw)
    for rel in ("FeatureData/i3d/feature.bin", "FeatureData/i3d/id.txt",
                "FeatureData/i3d/video2frames.txt",
                "TextData/synthetictrain.caption.txt",
                "TextData/synthetictest.caption.txt"):
        with open(os.path.join(ours, rel), "rb") as a, \
                open(os.path.join(theirs, rel), "rb") as b:
            assert a.read() == b.read(), rel
    q = "TextData/roberta_synthetic_query_feat.hdf5"
    with open_features(os.path.join(ours, q)) as a, \
            open_features(os.path.join(theirs, q)) as b:
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_array_equal(a[key][...], b[key][...])


def test_npz_feature_store_packs_like_hdf5(tmp_path):
    """The port's generator writes the same dataset with .npz feature
    stores (for machines without h5py); packing reads either."""
    packs = []
    for fmt in ("hdf5", "npz"):
        root = str(tmp_path / fmt)
        generate_dataset(root, n_videos={"test": 5}, d_student=16,
                         d_query=12, seed=1, feature_format=fmt)
        paths = dataset_paths(root, "synthetic", "i3d")
        assert paths["text_feat"].endswith("." + fmt)
        packs.append(pack_query_set(paths["cap_file"]["test"],
                                    paths["text_feat"], max_desc_l=8))
    np.testing.assert_array_equal(packs[0].feats, packs[1].feats)
    assert packs[0].cap_ids == packs[1].cap_ids
    with pytest.raises(ValueError, match="feature_format"):
        generate_dataset(str(tmp_path / "x"), feature_format="parquet")


@pytest.mark.parametrize("double", [True, False], ids=["double", "single"])
def test_eval_retrieval_matches_jax(dataset, double):
    """The resident engine at the JAX run's batches, and the router's
    resident route, give the JAX package's eval_retrieval metric dicts;
    the score matrices within F32_TOL."""
    _, _, videos, queries = dataset
    jmodel, params, model = _models(double)
    want = jax_eval.eval_retrieval(jmodel, params, videos, queries,
                                   context_bsz=4, query_bsz=7,
                                   corpus_stream_bsz=0)
    got = _metrics(evaluate.score_matrices(model, videos, queries, 4, 7,
                                           "cpu"), videos, queries)
    assert got == want
    assert evaluate.run_retrieval_eval(model, videos, queries, _eval_cfg(),
                                       device="cpu") == want
    if not double:
        assert "explore" not in got and got["fused"] == got["inher"]

    ci, ce, cm = jax_eval.embed_corpus(jmodel, params, videos, 4)
    want_s = jax_eval.score_all_queries(jmodel, params, queries, ci, ce, cm,
                                        query_bsz=7)
    got_s = evaluate.score_matrices(model, videos, queries, 4, 7, "cpu")
    assert (got_s[1] is None) == (want_s[1] is None)
    for g, w in zip(got_s, want_s):
        if w is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       atol=F32_TOL, rtol=0)


def test_eval_batching_invariance_and_padding(dataset):
    """Scores do not depend on the batch sizes; padded corpus rows carry
    zero masks and score -1e10."""
    _, _, videos, queries = dataset
    _, _, model = _models(True)
    n = len(videos)
    ca, ea, ma = evaluate.embed_corpus(model, videos, 3, "cpu")
    cb, eb, mb = evaluate.embed_corpus(model, videos, 14, "cpu")
    assert ca.shape[0] == 15 and cb.shape[0] == 14
    assert not ma[n:].any() and torch.equal(ma[:n], mb)
    torch.testing.assert_close(ca[:n], cb, atol=1e-5, rtol=0)
    sa, xa = evaluate.score_all_queries(model, queries, ca, ea, ma, 4)
    sb, xb = evaluate.score_all_queries(model, queries, cb, eb, mb, 50)
    assert sa.shape == (len(queries), 15)
    torch.testing.assert_close(sa[:, :n], sb, atol=1e-5, rtol=0)
    torch.testing.assert_close(xa[:, :n], xb, atol=1e-5, rtol=0)
    assert sa[:, n:].max() <= -1e9


def test_bf16_eval_runs(dataset):
    _, _, videos, queries = dataset
    _, params, _ = _models(True)
    model = load_jax_params(DLDKD(ModelConfig(double_branch=True,
                                              dtype="bfloat16", **_DIMS)),
                            jax.tree.map(np.asarray, params)).eval()
    ci, ce, _ = evaluate.embed_corpus(model, videos, 4, "cpu")
    assert ci.dtype == ce.dtype == torch.bfloat16
    out = evaluate.run_retrieval_eval(model, videos, queries, _eval_cfg(),
                                      device="cpu")
    assert set(out) == {"inher", "explore", "fused"}
    assert all(np.isfinite(v) for m in out.values() for v in m.values())


@pytest.mark.parametrize("double", [True, False], ids=["double", "single"])
def test_int8_eval_matches_jax(dataset, double):
    """The int8 engine (towers emit the int8 index, int8 scoring) against
    the JAX package's eval_retrieval(score_quant=True): equal metric dicts
    in f32, and valid-video scores bitwise equal where the int8 rows are
    equal."""
    _, _, videos, queries = dataset
    jmodel, params, model = _models(double)
    want = jax_eval.eval_retrieval(jmodel, params, videos, queries,
                                   context_bsz=4, query_bsz=7,
                                   score_quant=True, corpus_stream_bsz=0)
    got = _metrics(evaluate.score_matrices(model, videos, queries, 4, 7,
                                           "cpu", score_quant=True),
                   videos, queries)
    assert got == want
    assert evaluate.run_retrieval_eval(
        model, videos, queries, _eval_cfg(score_quant=True),
        device="cpu") == want

    ji, je, jb = jax_eval.embed_corpus_q8(jmodel, params, videos, 4)
    gi, ge, gb = evaluate.embed_corpus(model, videos, 4, "cpu",
                                       score_quant=True)
    n = len(videos)
    assert gi.dtype == torch.int8 and tuple(gb.shape) == (16, 16)
    # the JAX index is (L_p, Nv_p, H) with an (L_p, Nv_p) bias
    np.testing.assert_array_equal(
        gi[:n].numpy(), np.transpose(np.asarray(ji), (1, 0, 2))[:n, :16])
    np.testing.assert_array_equal(
        gb[:n].numpy(), np.asarray(jb).T[:n, :16])
    assert (ge is None) == (je is None) == (not double)
    ws = jax_eval.score_all_queries_q8(jmodel, params, queries, ji, je, jb,
                                       query_bsz=7)
    gs = evaluate.score_all_queries(model, queries, gi, ge, gb,
                                    query_bsz=7)
    for g, w in zip(gs, ws):
        if w is not None:
            np.testing.assert_array_equal(g[:, :n].numpy(),
                                          np.asarray(w)[:, :n])


def test_unported_routes_raise(dataset):
    """Every route is ported now: score_quant and streaming
    (test_int8_eval_matches_jax, tests/test_torch_streaming.py) and the
    mesh (tests/test_torch_parallel.py). On each engine route
    run_retrieval_eval on a mesh of three CPU shards gives the
    single-device metrics, and raises nothing."""
    from dldkd_tpu_torch.parallel import make_mesh

    _, _, videos, queries = dataset
    _, _, model = _models(True)
    eval_cfg = JaxConfig().eval
    for stream in (0, -1, 8):
        cfg = dataclasses.replace(eval_cfg, corpus_stream_bsz=stream)
        want = evaluate.run_retrieval_eval(model, videos, queries, cfg,
                                           device="cpu")
        got = evaluate.run_retrieval_eval(
            model, videos, queries, cfg,
            mesh=make_mesh(devices=["cpu"] * 3), device="cpu")
        assert got.keys() == want.keys()
        for branch in want:
            for k, v in want[branch].items():
                assert got[branch][k] == pytest.approx(v, abs=1e-9), \
                    (stream, branch, k)


def test_entry_points_default_to_cuda(dataset):
    """Without a GPU, an entry point that is not told device='cpu' raises
    instead of quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    _, _, videos, queries = dataset
    _, _, model = _models(True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate.run_retrieval_eval(model, videos, queries, _eval_cfg())


def _jax_run_dir(tmp_path, root, double):
    """A run dir as the JAX package's train driver leaves it: opt.json and
    ckpt/{model.ckpt, model_cfg.json}."""
    jmodel, params, _ = _models(double, seed=5)
    base = JaxConfig()
    cfg = dataclasses.replace(
        base, model=jmodel.config,
        data=dataclasses.replace(base.data, root_path=root,
                                 collection="synthetic",
                                 visual_feature="i3d", q_feat_size=48,
                                 max_ctx_l=16, max_desc_l=12),
        eval=dataclasses.replace(base.eval, eval_query_bsz=6,
                                 eval_context_bsz=4))
    run_dir = str(tmp_path / f"run_{double}")
    os.makedirs(run_dir)
    cfg.save(os.path.join(run_dir, "opt.json"))
    jax_ckpt.save_checkpoint(os.path.join(run_dir, "ckpt"), {
        "params": params, "opt_state": {}, "epoch": 4, "best_score": 9.0,
        "rng": jnp.zeros(2, jnp.uint32)}, jmodel.config)
    return run_dir, jmodel, params


def test_infer_score_quant_matches_jax(dataset, tmp_path, monkeypatch):
    """infer.main --score_quant (the resident int8 eval) gives the JAX
    package's int8 metrics on a checkpoint the JAX package wrote."""
    calls = []
    real = evaluate.embed_corpus

    def embed(*a, **k):
        out = real(*a, **k)
        calls.append(out[0].dtype)
        return out

    monkeypatch.setattr(evaluate, "embed_corpus", embed)
    root, paths, _, _ = dataset
    run_dir, jmodel, params = _jax_run_dir(tmp_path, root, True)
    videos = jax_ingest.pack_video_corpus(
        jax_ingest.read_video_ids(paths["cap_file"]["test"]),
        JaxBigFile(paths["visual_feat_dir"]),
        jax_ingest.read_dict(paths["video2frames"]), max_ctx_l=16)
    queries = jax_ingest.pack_query_set(paths["cap_file"]["test"],
                                        paths["text_feat"], max_desc_l=12)
    want = jax_eval.eval_retrieval(jmodel, params, videos, queries,
                                   context_bsz=4, query_bsz=6,
                                   score_quant=True, corpus_stream_bsz=0)
    got = infer.main(["--model_dir", run_dir, "--root_path", root,
                      "--torch_device", "cpu", "--score_quant"])
    assert got == want and calls == [torch.int8]


@pytest.mark.parametrize("double", [True, False], ids=["double", "single"])
def test_infer_reads_jax_checkpoint(dataset, tmp_path, double):
    root, paths, _, _ = dataset
    run_dir, jmodel, params = _jax_run_dir(tmp_path, root, double)
    videos = jax_ingest.pack_video_corpus(
        jax_ingest.read_video_ids(paths["cap_file"]["test"]),
        JaxBigFile(paths["visual_feat_dir"]),
        jax_ingest.read_dict(paths["video2frames"]), max_ctx_l=16)
    queries = jax_ingest.pack_query_set(paths["cap_file"]["test"],
                                        paths["text_feat"], max_desc_l=12)
    want = jax_eval.eval_retrieval(jmodel, params, videos, queries,
                                   context_bsz=4, query_bsz=6,
                                   corpus_stream_bsz=0)
    got = infer.main(["--model_dir", run_dir, "--root_path", root,
                      "--torch_device", "cpu"])
    assert got == want
    cfg = parse_args(["--model_dir", run_dir, "--root_path", root],
                     test=True, finalize=False)
    assert cfg.torch_device == "cuda"
    assert infer.start_inference(cfg, device="cpu") == want
    with open(os.path.join(run_dir, "eval.log.txt")) as f:
        assert "test fused: r_1_5_10_100" in f.read()


def test_infer_profile_dir_traces_the_eval(dataset, tmp_path):
    """infer.main --profile_dir writes the eval's chrome trace (its spans,
    utils/tracing.py) and its counters, and the metrics are unchanged."""
    root, _, _, _ = dataset
    run_dir, _, _ = _jax_run_dir(tmp_path, root, True)
    args = ["--model_dir", run_dir, "--root_path", root,
            "--torch_device", "cpu"]
    want = infer.main(args)
    prof = str(tmp_path / "prof")
    assert infer.main(args + ["--profile_dir", prof]) == want
    with open(os.path.join(prof, "trace.json")) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"]
    assert names.count("eval/run") == 1
    # 10 test videos in one context batch (the CLI's default, 200)
    assert names.count("kernels/context_tower") == 1
    with open(os.path.join(prof, "counts.json")) as f:
        assert json.load(f)["eval.h2d_bytes"] > 0
