"""Serving index artifacts across the two packages, on the CPU: the port's
`Retriever.save_index` / `load_index` against `dldkd_tpu.serving`'s, on a
near-tie corpus built like tests/test_rescore.py's (clusters of
near-duplicate videos 1e-3 apart, below the int8 grid and above f32
resolution) with ragged frame masks.

- The port's params fingerprint and `repr(ModelConfig)` are the JAX
  package's, so strict loading accepts the other package's artifacts.
- JAX -> port: an artifact of each store (encoded from the exact route,
  encoded from the two-stage route, int8-only, raw) loads in the port with
  strict=True and serves the JAX retriever's ids; port -> JAX the same.
  Scores agree to 1e-5 (f32 towers and scoring of both packages, sums in
  another order); ids are equal.
- A port round trip is bitwise in the arrays (real rows) and in ids and
  scores.
- Re-saving swaps the artifact whole; a fingerprint mismatch is refused
  unless strict=False; an int8-only artifact refuses a rescoring
  retriever; the prewarm manifest; warm_start; the CLI.

Both packages are pinned to one stage-2 engine with DLDKD_DENSE_RESCORE,
so parity never rests on either cost model.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dldkd_tpu.serving as jax_serving
from dldkd_tpu import checkpoint as jax_ckpt
from dldkd_tpu.config import ModelConfig as JaxModelConfig
from dldkd_tpu.data.ingest import PackedVideos as JaxPackedVideos
from dldkd_tpu.data.synthetic import generate_dataset as jax_generate
from dldkd_tpu.models import DLDKD as JaxDLDKD
from dldkd_tpu.train import init_params
from dldkd_tpu.utils import index_io as jax_index_io
from dldkd_tpu_torch import serving
from dldkd_tpu_torch.config import ModelConfig
from dldkd_tpu_torch.convert import load_jax_params
from dldkd_tpu_torch.data.ingest import PackedVideos
from dldkd_tpu_torch.models import DLDKD
from dldkd_tpu_torch.ops.kernels import build
from dldkd_tpu_torch.utils import index_io

N_CLUSTERS, PER_CLUSTER, L, DV, DQ = 4, 12, 8, 16, 12
N_VID = N_CLUSTERS * PER_CLUSTER
N_Q, K, BSZ = 10, 5, 8
SCORE_TOL = 1e-5
_DIMS = dict(visual_input_size=DV, query_input_size=DQ, inheritance_hidden=8,
             exploration_hidden=8, max_ctx_l=L, max_desc_l=4, n_heads=2,
             double_branch=True, label_style="soft")
# each store: (retriever keywords, DLDKD_DENSE_RESCORE)
STORES = {"exact": ({}, None),
          "two_stage": ({"score_quant": True}, "never"),
          "q8": ({"score_quant": True, "rescore": False}, None),
          "raw": ({"index_store": "raw", "stream_block": 20}, None)}


@pytest.fixture(autouse=True, scope="module")
def _torch_numerics():
    threads = torch.get_num_threads()
    precision = torch.get_float32_matmul_precision()
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(threads)
    torch.set_float32_matmul_precision(precision)


def _models(dims=_DIMS, seed=0):
    jcfg = JaxModelConfig(**dims)
    jmodel = JaxDLDKD(config=jcfg)
    params = init_params(jmodel, jcfg, seed)
    model = load_jax_params(DLDKD(ModelConfig(**dims)),
                            jax.tree.map(np.asarray, params)).eval()
    return jmodel, params, model


@pytest.fixture(scope="module")
def corpus():
    jmodel, params, model = _models()
    rng = np.random.RandomState(7)
    bases = rng.randn(N_CLUSTERS, L, DV).astype(np.float32)
    feats = np.stack([bases[i % N_CLUSTERS]
                      + 1e-3 * rng.randn(L, DV).astype(np.float32)
                      for i in range(N_VID)])
    mask = np.ones((N_VID, L), np.float32)
    for i in range(N_VID):
        mask[i, L - (i % 3):] = 0.0          # ragged: 8, 7 or 6 frames
    ids = [f"v{i}" for i in range(N_VID)]
    qf = rng.randn(N_Q, 4, DQ).astype(np.float32)
    qm = np.ones((N_Q, 4), np.float32)
    return dict(jmodel=jmodel, params=params, model=model,
                jvideos=JaxPackedVideos(feats=feats, mask=mask, ids=ids),
                videos=PackedVideos(feats=feats, mask=mask, ids=ids),
                qf=qf, qm=qm)


def _pin(monkeypatch, mode):
    if mode is None:
        monkeypatch.delenv("DLDKD_DENSE_RESCORE", raising=False)
    else:
        monkeypatch.setenv("DLDKD_DENSE_RESCORE", mode)
    # the jitted search programs read the mode when they trace
    for fn in (jax_serving._search_jit, jax_serving._search_q8_jit,
               jax_serving._encoded_block_topk_jit):
        fn.clear_cache()


def _jax_retriever(c, params=None, **kw):
    r = jax_serving.Retriever(c["jmodel"], c["params"] if params is None
                              else params, query_bsz=BSZ, mesh=None, **kw)
    r.mesh = None  # the single-device path
    return r


def _port(c, model=None, **kw):
    return serving.Retriever(c["model"] if model is None else model,
                             query_bsz=BSZ, device="cpu", **kw)


def _search(r, c, k=K):
    return r.search(c["qf"], c["qm"], k=k)


def _assert_same(got, want, bitwise=False):
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    if bitwise:
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    else:
        np.testing.assert_allclose(got[0], np.asarray(want[0]),
                                   atol=SCORE_TOL, rtol=0)


@pytest.mark.parametrize("dims", [
    None, dict(_DIMS, double_branch=False, dtype="bfloat16",
               inheritance_hidden=16)], ids=["dual", "single_bf16"])
def test_fingerprint_and_model_config_repr_match_jax(corpus, dims):
    if dims is None:
        dims, params, model = _DIMS, corpus["params"], corpus["model"]
    else:
        _, params, model = _models(dims, seed=3)
    assert index_io.params_fingerprint(model) \
        == jax_index_io.params_fingerprint(params)
    assert repr(model.config) == repr(JaxModelConfig(**dims))
    other = jax.tree.map(lambda p: p + 1e-3, params)
    assert jax_index_io.params_fingerprint(other) \
        != index_io.params_fingerprint(model)


@pytest.mark.parametrize("store", list(STORES))
def test_jax_artifact_loads_in_port(corpus, tmp_path, monkeypatch, store):
    """A dldkd_tpu artifact of each store loads strictly in the port and
    serves the JAX retriever's ids."""
    kw, mode = STORES[store]
    _pin(monkeypatch, mode)
    jr = _jax_retriever(corpus, **kw)
    jr.index(corpus["jvideos"])
    want = _search(jr, corpus)
    jr.save_index(str(tmp_path / "idx"))
    r = _port(corpus, **kw)
    r.load_index(str(tmp_path / "idx"), strict=True)
    assert r.video_ids == corpus["videos"].ids
    _assert_same(_search(r, corpus), want)
    if store == "q8":
        # the JAX rows carry the TPU frame tile's padding: trimmed on load
        assert r.q8_inher.shape[1] == L and r.ctx_inher is None


@pytest.mark.parametrize("store", list(STORES))
def test_port_artifact_loads_in_jax(corpus, tmp_path, monkeypatch, store):
    """A port artifact of each store loads strictly in dldkd_tpu and serves
    the port's ids. The exact store's frames are written L2-normalized
    (meta "frames_normalized"): the JAX retriever normalizes them again per
    search, so its scores move by f32 ulps, its ids not."""
    kw, mode = STORES[store]
    _pin(monkeypatch, mode)
    r = _port(corpus, **kw)
    r.index(corpus["videos"])
    want = _search(r, corpus)
    r.save_index(str(tmp_path / "idx"))
    meta = jax_index_io.read_meta(str(tmp_path / "idx"))
    assert meta.get("frames_normalized", False) == (store == "exact")
    jr = _jax_retriever(corpus, **kw)
    jr.load_index(str(tmp_path / "idx"), strict=True)
    _assert_same(_search(jr, corpus), want)


@pytest.mark.parametrize("store", list(STORES))
def test_port_round_trip_is_bitwise(corpus, tmp_path, monkeypatch, store):
    kw, mode = STORES[store]
    _pin(monkeypatch, mode)
    r1 = _port(corpus, **kw)
    r1.index(corpus["videos"])
    want = _search(r1, corpus)
    r1.save_index(str(tmp_path / "idx"))
    r2 = _port(corpus, **kw)
    r2.load_index(str(tmp_path / "idx"))
    n = N_VID
    for name in ("ctx_inher", "ctx_explore", "q8_inher", "q8_explore",
                 "raw_feats"):
        a, b = getattr(r1, name), getattr(r2, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.shape == b.shape and a.dtype == b.dtype, name
            assert torch.equal(a[:n], b[:n]), name
    for name in ("vmask", "q8_bias", "raw_mask"):
        a, b = getattr(r1, name), getattr(r2, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), name
    assert r2.index_store == r1.index_store
    _assert_same(_search(r2, corpus), want, bitwise=True)


@pytest.mark.parametrize("mode", ["never", "always"])
def test_exact_artifact_serves_two_stage_port(corpus, tmp_path, monkeypatch,
                                              mode):
    """Every route reads an encoded artifact: an exact-built one (frames
    normalized) serves a two-stage retriever, which rebuilds its int8
    companions on load, with the exact ids; a JAX one (frames as the
    towers wrote them) gives a two-stage retriever the arrays its own
    index() builds from the same frames."""
    _pin(monkeypatch, mode)
    r = _port(corpus)
    r.index(corpus["videos"])
    exact = _search(r, corpus)
    r.save_index(str(tmp_path / "idx"))
    rq = _port(corpus, score_quant=True)
    rq.load_index(str(tmp_path / "idx"))
    assert rq.q8_inher is not None and rq.frames_normalized
    _assert_same(_search(rq, corpus), exact)
    jr = _jax_retriever(corpus, score_quant=True)
    jr.index(corpus["jvideos"])
    jr.save_index(str(tmp_path / "jidx"))
    a = _port(corpus, score_quant=True)
    a.load_index(str(tmp_path / "jidx"))
    b = _port(corpus, score_quant=True)
    b.vmask = a.vmask
    b._set_frames(a.ctx_inher, a.ctx_explore, normalized=False)
    assert torch.equal(a.q8_inher, b.q8_inher)
    assert torch.equal(a.q8_bias, b.q8_bias)


def test_resave_replaces_artifact_atomically(corpus, tmp_path):
    path = str(tmp_path / "idx")
    r1 = _port(corpus)
    r1.index(corpus["videos"])
    r1.save_index(path)
    _, other_params, other = _models(seed=5)
    rb = _port(corpus, model=other)
    rb.index(corpus["videos"])
    rb.save_index(path)
    with pytest.raises(ValueError, match="different"):
        _port(corpus).load_index(path)
    r_new = _port(corpus, model=other)
    r_new.load_index(path)
    _assert_same(_search(r_new, corpus), _search(rb, corpus), bitwise=True)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["idx"]


def test_fingerprint_mismatch_refused_unless_forced(corpus, tmp_path, caplog):
    r1 = _port(corpus)
    r1.index(corpus["videos"])
    r1.save_index(str(tmp_path / "idx"))
    _, _, other = _models(seed=5)
    r2 = _port(corpus, model=other)
    with pytest.raises(ValueError, match="strict=False"):
        r2.load_index(str(tmp_path / "idx"))
    r2.load_index(str(tmp_path / "idx"), strict=False)
    assert r2.video_ids == corpus["videos"].ids
    assert "loading anyway" in caplog.text


def test_int8_only_artifact_refuses_rescoring_retrievers(corpus, tmp_path):
    r = _port(corpus, score_quant=True, rescore=False)
    r.index(corpus["videos"])
    r.save_index(str(tmp_path / "idx8"))
    for kw in ({}, {"score_quant": True}):
        with pytest.raises(ValueError, match="int8-only"):
            _port(corpus, **kw).load_index(str(tmp_path / "idx8"))


def test_prewarm_manifest(corpus, tmp_path, monkeypatch):
    """save_index(prewarm) runs each signature once and records
    [query_bsz, lq, k]; load_index runs the rows of its own batch size."""
    ran = []
    monkeypatch.setattr(serving.Retriever, "_warm",
                        lambda self, lq, k: ran.append((self.query_bsz,
                                                        lq, k)))
    r = _port(corpus, score_quant=True)
    r.index(corpus["videos"])
    with pytest.raises(ValueError, match="int8"):
        exact = _port(corpus)
        exact.index(corpus["videos"])
        exact.save_index(str(tmp_path / "no"), prewarm=[(4, 3)])
    assert not os.path.exists(tmp_path / "no") and not ran
    r.save_index(str(tmp_path / "idx"), prewarm=[(4, 3), (8, 5)])
    meta = index_io.read_meta(str(tmp_path / "idx"))
    assert meta["prewarm_signatures"] == [[BSZ, 4, 3], [BSZ, 8, 5]]
    assert ran == [(BSZ, 4, 3), (BSZ, 8, 5)]
    ran.clear()
    _port(corpus, score_quant=True).load_index(str(tmp_path / "idx"))
    assert ran == [(BSZ, 4, 3), (BSZ, 8, 5)]
    ran.clear()
    other = serving.Retriever(corpus["model"], query_bsz=4, device="cpu",
                              score_quant=True)
    other.load_index(str(tmp_path / "idx"))
    assert ran == []
    monkeypatch.undo()
    # a real warm search: zero queries through the route
    r._warm(4, 3)


def test_warm_start_is_a_cold_score_quant_retriever(corpus, monkeypatch):
    _pin(monkeypatch, "never")
    for kw in ({"score_quant": True}, {"score_quant": True,
                                       "rescore": False}):
        cold = _port(corpus, **kw)
        cold.index(corpus["videos"])
        warm = _port(corpus, warm_start=True, **kw)
        warm.index(corpus["videos"])
        _assert_same(_search(warm, corpus), _search(cold, corpus),
                     bitwise=True)


def test_aot_cache_dir_is_the_kernel_library_dir(corpus, tmp_path,
                                                 monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    _port(corpus, aot_cache_dir=str(tmp_path / "libs"))
    assert build.BUILD_DIR == (tmp_path / "libs").resolve()
    assert build.library_path("tower").parent == build.BUILD_DIR
    assert (tmp_path / "libs").is_dir()


def test_serving_cli_prewarm_validation():
    """--prewarm misconfigurations die at argparse time, before the corpus
    is touched (tests/test_serving.py:663's cases)."""
    base = ["--model_dir", "/nonexistent", "--root_path", "/nonexistent",
            "--collection", "c", "--visual_feature", "v"]
    for extra in (
            ["--save_index", "/tmp/i", "--prewarm", "4:3"],      # no quant
            ["--queries", "q.npz", "--score_quant",
             "--prewarm", "4:3"],                                # no save
            ["--save_index", "/tmp/i", "--score_quant",
             "--prewarm", "4:3:2"],                              # bad spec
            ["--save_index", "/tmp/i", "--score_quant",
             "--prewarm", "a:b"]):                               # bad spec
        with pytest.raises(SystemExit):
            serving.main(base + extra)
    assert serving.parse_prewarm("32:10,32:100") == [(32, 10), (32, 100)]


def test_serving_cli_save_then_load(tmp_path):
    """--save_index without --queries writes the artifact and exits;
    --load_index with .npz queries needs no dataset flags and writes the
    lines a build in the same process writes."""
    import h5py

    root = str(tmp_path / "data")
    jax_generate(root, n_videos={"test": 7}, frames_range=(3, 12),
                 d_student=16, d_query=12, d_teacher=4, seed=5)
    jcfg = JaxModelConfig(**{**_DIMS, "max_ctx_l": 12, "max_desc_l": 6})
    params = init_params(JaxDLDKD(config=jcfg), jcfg, 3)
    run_dir = tmp_path / "run"
    jax_ckpt.save_checkpoint(str(run_dir / "ckpt"), {
        "params": params, "opt_state": {}, "epoch": 1, "best_score": 0.0,
        "rng": jnp.zeros(2, jnp.uint32)}, jcfg)
    h5 = f"{root}/synthetic/TextData/roberta_synthetic_query_feat.hdf5"
    npz = str(tmp_path / "queries.npz")
    with h5py.File(h5, "r") as f:
        np.savez(npz, **{k: f[k][...] for k in f.keys()})
    dataset = ["--root_path", root, "--collection", "synthetic",
               "--visual_feature", "i3d"]
    common = ["--model_dir", str(run_dir), "--torch_device", "cpu",
              "--score_quant", "--k", "4"]
    idx = str(tmp_path / "idx")
    serving.main(common + dataset + ["--save_index", idx,
                                     "--prewarm", "6:4"])
    meta = index_io.read_meta(idx)
    assert meta["n_videos"] == 7 and meta["mode"] == "encoded"
    assert meta["prewarm_signatures"] == [[256, 6, 4]]
    assert not os.path.exists(tmp_path / "built.jsonl")
    serving.main(common + ["--load_index", idx, "--queries", npz,
                           "--out", str(tmp_path / "loaded.jsonl")])
    serving.main(common + dataset + ["--queries", npz,
                                     "--out", str(tmp_path / "built.jsonl")])
    got = [json.loads(x) for x in open(tmp_path / "loaded.jsonl")]
    want = [json.loads(x) for x in open(tmp_path / "built.jsonl")]
    assert len(got) == len(want) > 7 and got == want
    with pytest.raises(SystemExit):   # caption-file queries need the dataset
        serving.main(common + ["--load_index", idx, "--queries",
                               "captions.txt"])
