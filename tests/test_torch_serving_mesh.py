"""Corpus-sharded serving (`serving.Retriever(mesh=...)`) on the CPU,
against the port's single-device Retriever and the JAX package's Retriever
on its 8 CPU devices (the suite's conftest) and on one (mesh None).

- Meshes of 1, 2, 3 and 8 shards on the CPU (`make_mesh(devices=["cpu"] *
  n)`, several shards on one device), on the JAX tests' corpora
  (tests/test_serving.py: 19 videos, 45 with a stream block of 3;
  tests/test_parallel.py: 21, ragged masks), shortlist factor 8: every
  store and route (encoded exact, two-stage with the gather and with the
  dense stage 2, both pinned by DLDKD_DENSE_RESCORE in both packages,
  int8-only; raw exact, two-stage, int8-only), two-branch and one-branch
  models: ids equal, scores within 1e-5 (f32: the plain versions' products
  at other shapes, and the other package, sum in another order).
- A one-branch model scores each shard once per query batch; the query
  towers run once per batch, whatever the shard count.
- Index artifacts cross between topologies and packages
  (tests/test_serving.py:387-520): encoded, int8-only and raw, saved on a
  mesh or one device, loaded on the other, and between the port's and the
  JAX package's meshes; a mesh-saved artifact's arrays are bitwise a
  single-device save's.
- ROADMAP C10: on the clustered corpus of tests/test_torch_serving.py
  (int8 ties inside each cluster) the raw int8-only store on a mesh breaks
  ties by video id, as one device does; the JAX package's raw+mesh store
  merges (block, device) and returns other tied videos.
- `auto_index_store` counts every shard a device holds.
- A two-rank gloo world (subprocesses of `test_torch_parallel_worker.py`):
  both ranks return the single-device ids, and save and load artifacts.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import dldkd_tpu.serving as jax_serving
from dldkd_tpu.config import ModelConfig as JaxModelConfig
from dldkd_tpu.data.ingest import PackedVideos as JaxPackedVideos
from dldkd_tpu.models import DLDKD as JaxDLDKD
from dldkd_tpu.parallel import make_mesh as jax_make_mesh
from dldkd_tpu.train import init_params
from dldkd_tpu_torch import serving
from dldkd_tpu_torch.config import ModelConfig
from dldkd_tpu_torch.convert import load_jax_params
from dldkd_tpu_torch.data.ingest import PackedVideos
from dldkd_tpu_torch.models import DLDKD
from dldkd_tpu_torch.parallel import make_mesh
from dldkd_tpu_torch.utils import index_io
from tests.test_torch_parallel import _run_workers
from tests.test_torch_serving import clustered  # noqa: F401

# tests/test_serving.py's model
DIMS = dict(visual_input_size=16, query_input_size=12, inheritance_hidden=8,
            exploration_hidden=8, max_ctx_l=8, max_desc_l=4, n_heads=2,
            label_style="soft")
N_Q, QUERY_BSZ, K, BLOCK, FACTOR = 7, 4, 6, 3, 8
SCORE_TOL = 1e-5
SHARDS = (1, 2, 3, 8)
# (route, Retriever keywords, DLDKD_DENSE_RESCORE, corpus size)
ROUTES = {
    "exact": ({}, None, 19),
    "two_stage_gather": ({"score_quant": True}, "never", 21),
    "two_stage_dense": ({"score_quant": True}, "always", 21),
    "int8": ({"score_quant": True, "rescore": False}, None, 19),
    "raw_exact": ({"index_store": "raw"}, None, 45),
    "raw_two_stage": ({"index_store": "raw", "score_quant": True}, "always",
                      45),
    "raw_int8": ({"index_store": "raw", "score_quant": True,
                  "rescore": False}, None, 45),
}
_JAX_PROGRAMS = ("_search_jit", "_search_q8_jit", "_search_sharded_jit",
                 "_search_q8_sharded_jit", "_encoded_block_topk_jit",
                 "_encoded_block_topk_sharded_jit")


@pytest.fixture(autouse=True, scope="module")
def _torch_numerics():
    threads = torch.get_num_threads()
    precision = torch.get_float32_matmul_precision()
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(threads)
    torch.set_float32_matmul_precision(precision)


_MODELS = {}


def _models(double: bool):
    """(JAX model, its params, the port's model on the same weights)."""
    if double not in _MODELS:
        jcfg = JaxModelConfig(double_branch=double, **DIMS)
        jmodel = JaxDLDKD(config=jcfg)
        params = init_params(jmodel, jcfg, 0)
        model = load_jax_params(
            DLDKD(ModelConfig(double_branch=double, **DIMS)),
            jax.tree.map(np.asarray, params)).eval()
        _MODELS[double] = (jmodel, params, model)
    return _MODELS[double]


def _corpus(n_vid: int):
    """(feats, mask, ids, query feats, query mask): the JAX serving tests'
    corpora (19: RandomState(4), 45: RandomState(7), all frames valid) and
    tests/test_parallel.py's 21 videos with ragged masks."""
    rng = np.random.RandomState({19: 4, 21: 1, 45: 7}[n_vid])
    feats = rng.randn(n_vid, 8, 16).astype(np.float32)
    mask = np.ones((n_vid, 8), np.float32)
    if n_vid == 21:
        mask[rng.rand(n_vid, 8) < 0.2] = 0
        mask[:, 0] = 1
    qf = rng.randn(N_Q, 4, 12).astype(np.float32)
    qm = np.ones((N_Q, 4), np.float32)
    qm[::3, 3:] = 0
    return feats, mask, [f"v{i}" for i in range(n_vid)], qf, qm


def _videos(n_vid, jax_side=False):
    feats, mask, ids, _, _ = _corpus(n_vid)
    return (JaxPackedVideos if jax_side else PackedVideos)(
        feats=feats, mask=mask, ids=ids)


def _kw(route):
    kw, _, _ = ROUTES[route]
    return dict(kw, query_bsz=QUERY_BSZ, shortlist_factor=FACTOR,
                stream_block=BLOCK)


def _set_mode(monkeypatch, mode):
    if mode is None:
        monkeypatch.delenv("DLDKD_DENSE_RESCORE", raising=False)
    else:
        monkeypatch.setenv("DLDKD_DENSE_RESCORE", mode)
    # the JAX search programs read the mode when they trace
    for name in _JAX_PROGRAMS:
        getattr(jax_serving, name).clear_cache()


def _jax_retriever(route, double, mesh):
    jmodel, params, _ = _models(double)
    r = jax_serving.Retriever(jmodel, params, mesh=mesh, **_kw(route))
    r.mesh = mesh   # None: the single-device path
    return r


_REFS = {}


def _references(route, double, monkeypatch):
    """(port single device, JAX on 8 devices, JAX on one) search results of
    one route."""
    key = (route, double)
    if key not in _REFS:
        _, mode, n_vid = ROUTES[route]
        _set_mode(monkeypatch, mode)
        _, _, _, qf, qm = _corpus(n_vid)
        single = serving.Retriever(_models(double)[2], device="cpu",
                                   **_kw(route))
        single.index(_videos(n_vid))
        out = [single.search(qf, qm, K)]
        for mesh in (jax_make_mesh(8), None):
            r = _jax_retriever(route, double, mesh)
            r.index(_videos(n_vid, jax_side=True))
            out.append(tuple(np.asarray(t) for t in r.search(qf, qm, K)))
        _REFS[key] = out
    return _REFS[key]


def _assert_same(got, want, what):
    np.testing.assert_array_equal(got[1], want[1], err_msg=what)
    np.testing.assert_allclose(got[0], want[0], atol=SCORE_TOL, rtol=0,
                               err_msg=what)


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("double", [True, False], ids=["2br", "1br"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_mesh_search_matches_single_device_and_jax(route, double, n_shards,
                                                   monkeypatch):
    single, jax_mesh, jax_single = _references(route, double, monkeypatch)
    _, mode, n_vid = ROUTES[route]
    _set_mode(monkeypatch, mode)
    _, _, _, qf, qm = _corpus(n_vid)
    r = serving.Retriever(_models(double)[2], device="cpu",
                          mesh=make_mesh(devices=["cpu"] * n_shards),
                          **_kw(route))
    r.index(_videos(n_vid))
    got = r.search(qf, qm, K)
    assert got[1].shape == (N_Q, K) and got[0].dtype == np.float32
    _assert_same(got, single, "the port on one device")
    _assert_same(got, jax_mesh, "dldkd_tpu on 8 devices")
    _assert_same(got, jax_single, "dldkd_tpu on one device")


def _counting(monkeypatch, names):
    calls = []
    for name in names:
        real = getattr(serving, name)
        monkeypatch.setattr(serving, name, lambda *a, _real=real, **k:
                            calls.append(1) or _real(*a, **k))
    return calls


@pytest.mark.parametrize("route", ["exact", "two_stage_dense", "int8",
                                   "raw_exact"])
def test_one_branch_scores_each_shard_once(route, monkeypatch):
    """A one-branch model's search calls each scorer once per live shard
    and query batch (raw: per shard block), half the two-branch model's;
    the query towers run once per batch on the first device."""
    _, mode, n_vid = ROUTES[route]
    _set_mode(monkeypatch, mode)
    _, _, _, qf, qm = _corpus(n_vid)
    mesh = make_mesh(devices=["cpu"] * 8)
    batches = -(-N_Q // QUERY_BSZ)
    for double, factor in ((False, 1), (True, 2)):
        r = serving.Retriever(_models(double)[2], device="cpu", mesh=mesh,
                              **_kw(route))
        r.index(_videos(n_vid))
        live = len(r._live())
        per = -(-n_vid // 8)
        assert live == sum(1 for s in range(8) if s * per < n_vid)
        scorers = _counting(monkeypatch, [
            "clip_scores_maxpool", "clip_scores_maxpool_pre8",
            "exact_clip_scores"])
        towers = _counting(monkeypatch, ["encode_query_best"])
        r.search(qf, qm, K)
        monkeypatch.undo()
        _set_mode(monkeypatch, mode)
        per_shard = {"exact": batches, "int8": batches,
                     # stage 1 on the index, stage 2 dense
                     "two_stage_dense": 2 * batches,
                     # every query at once, per block of the shard
                     "raw_exact": sum(-(-sh.real // BLOCK)
                                      for sh in r._live())}[route]
        want = factor * (per_shard if route == "raw_exact"
                         else live * per_shard)
        assert len(scorers) == want, (double, len(scorers), want)
        assert len(towers) == batches


def _search_same(r, qf, qm, want, what):
    _assert_same(r.search(qf, qm, K), want, what)


@pytest.mark.parametrize("route", ["exact", "two_stage_dense", "int8",
                                   "raw_exact"])
def test_artifacts_cross_topologies(route, tmp_path, monkeypatch):
    """Saved on a mesh of 3, loaded on one device and on a mesh of 8 (and
    the reverse): the building retriever's ids and scores (within 1e-5:
    the plain products at other shapes); the mesh's arrays are bitwise the
    single-device save's; the int8 stores' prewarm manifest is written
    and run on both topologies."""
    _, mode, n_vid = ROUTES[route]
    _set_mode(monkeypatch, mode)
    _, _, _, qf, qm = _corpus(n_vid)
    model = _models(True)[2]

    def retriever(n):
        return serving.Retriever(
            model, device="cpu", **_kw(route),
            mesh=None if n is None else make_mesh(devices=["cpu"] * n))

    # a prewarm manifest where the store has the int8 index: the mesh
    # runs its signature at save and at load
    prewarm = [(4, 3)] if ROUTES[route][0].get("score_quant") else None
    built = {}
    for n in (None, 3):
        r = retriever(n)
        r.index(_videos(n_vid))
        built[n] = r.search(qf, qm, K)
        r.save_index(str(tmp_path / f"idx_{n}"), prewarm=prewarm)
        assert index_io.read_meta(str(tmp_path / f"idx_{n}")).get(
            "prewarm_signatures") == (None if prewarm is None
                                      else [[QUERY_BSZ, 4, 3]])
    for name in os.listdir(tmp_path / "idx_None"):
        if name.endswith(".npy"):
            np.testing.assert_array_equal(
                np.load(tmp_path / "idx_None" / name),
                np.load(tmp_path / "idx_3" / name), err_msg=name)
    for saved, loaded in ((3, None), (None, 8), (3, 8)):
        r = retriever(loaded)
        r.load_index(str(tmp_path / f"idx_{saved}"))
        _search_same(r, qf, qm, built[saved], f"{saved} -> {loaded}")


@pytest.mark.parametrize("route", ["exact", "int8", "raw_exact"])
def test_artifacts_cross_packages_on_meshes(route, tmp_path, monkeypatch):
    """A JAX 8-device mesh's artifact loads on the port's mesh of 3 and
    serves the JAX ids; the port mesh's artifact loads in the JAX
    Retriever, on 8 devices and on one, with the port's ids."""
    _, mode, n_vid = ROUTES[route]
    _set_mode(monkeypatch, mode)
    _, _, _, qf, qm = _corpus(n_vid)
    jr = _jax_retriever(route, True, jax_make_mesh(8))
    jr.index(_videos(n_vid, jax_side=True))
    want_jax = tuple(np.asarray(t) for t in jr.search(qf, qm, K))
    jr.save_index(str(tmp_path / "jax"))
    mesh = make_mesh(devices=["cpu"] * 3)
    r = serving.Retriever(_models(True)[2], device="cpu", mesh=mesh,
                          **_kw(route))
    r.load_index(str(tmp_path / "jax"))
    _assert_same(r.search(qf, qm, K), want_jax, "JAX mesh artifact")
    r.index(_videos(n_vid))
    want = r.search(qf, qm, K)
    r.save_index(str(tmp_path / "port"))
    for jmesh in (jax_make_mesh(8), None):
        jr = _jax_retriever(route, True, jmesh)
        jr.load_index(str(tmp_path / "port"))
        _assert_same(tuple(np.asarray(t) for t in jr.search(qf, qm, K)),
                     want, f"port mesh artifact in dldkd_tpu ({jmesh})")


def test_raw_int8_mesh_breaks_ties_by_video_id(clustered):  # noqa: F811
    """ROADMAP C10. Int8 ties inside each cluster: the port's raw
    int8-only store on a mesh of 8 (stream block 3) returns the
    single-device ids, which are also the JAX package's on one device
    (ties by video id). The JAX package's raw+mesh store merges its
    candidates in (block, device) order and returns other videos of the
    same ties: its scores are the same, its ids differ on some rows."""
    jmodel, params, jvideos, model, videos, qf, qm = clustered
    kw = dict(query_bsz=8, score_quant=True, rescore=False,
              index_store="raw", stream_block=BLOCK)
    single = serving.Retriever(model, device="cpu", **kw)
    single.index(videos)
    want = single.search(qf, qm, 5)
    r = serving.Retriever(model, device="cpu",
                          mesh=make_mesh(devices=["cpu"] * 8), **kw)
    r.index(videos)
    _assert_same(r.search(qf, qm, 5), want, "port mesh")
    got_jax = {}
    for mesh in (None, jax_make_mesh(8)):
        jr = jax_serving.Retriever(jmodel, params, mesh=mesh, **kw)
        jr.mesh = mesh
        jr.index(jvideos)
        got_jax[mesh is None] = tuple(np.asarray(t)
                                      for t in jr.search(qf, qm, 5))
    _assert_same(got_jax[True], want, "dldkd_tpu on one device")
    np.testing.assert_allclose(got_jax[False][0], want[0], atol=SCORE_TOL,
                               rtol=0)
    assert (got_jax[False][1] != want[1]).any()


def test_mesh_refusals_and_defaults():
    """A mesh of one takes the sharded route; the device is the mesh's
    first; auto placement needs several GPUs."""
    model = _models(True)[2]
    r = serving.Retriever(model, device="cpu",
                          mesh=make_mesh(devices=["cpu"]))
    r.index(_videos(19))
    assert r.mesh.size == 1 and len(r.shards) == 1 and r.ctx_inher is None
    assert r.device == torch.device("cpu")
    assert serving.Retriever(model, device="cpu").mesh is None
    r = serving.Retriever(model, mesh=make_mesh(devices=["cpu"] * 2))
    assert r.device == torch.device("cpu")


def test_auto_index_store_counts_every_shard_on_a_device(monkeypatch):
    """Two shards on one device need that device to hold both shards'
    rows: a budget that fits one shard's index (and the single-device
    store of as many rows) picks 'raw' for the mesh."""
    model = _models(True)[2]
    n = 45
    probe = serving.Retriever(model, device="cpu")
    per = -(-n // 2)
    budget = (probe._index_bytes(per) + probe._index_bytes(2 * per)) // 2
    monkeypatch.setattr(serving, "device_memory_budget", lambda d: budget)
    assert probe.auto_index_store(per) == "encoded"
    assert probe.auto_index_store(n) == "raw"
    two = serving.Retriever(model, device="cpu", stream_block=1,
                            mesh=make_mesh(devices=["cpu"] * 2))
    assert two.auto_index_store(n) == "raw"
    assert two.auto_index_store(per) == "encoded"
    two.index(_videos(n))
    assert two.index_store == "raw" and two.raw_per_dev == per


# ------------------------------------------------ a two-rank gloo world

GLOO_ROUTES = ("exact", "two_stage_dense", "int8", "raw_two_stage")


def test_two_rank_gloo_world_serves_single_device_ids(tmp_path,
                                                      monkeypatch):
    """Two gloo ranks, two shards each: every route returns the
    single-device ids and scores on both ranks; the group saves an
    artifact a single device loads, and loads a single-device one."""
    n_vid = 21
    feats, mask, ids, qf, qm = _corpus(n_vid)
    model = _models(True)[2]
    torch.save(model.state_dict(), tmp_path / "model.pt")
    np.savez(tmp_path / "data.npz", feats=feats, mask=mask, qf=qf, qm=qm)
    spec = {"model": dict(DIMS, double_branch=True), "k": K,
            "routes": {route: _kw(route) for route in GLOO_ROUTES},
            "modes": {route: ROUTES[route][1] for route in GLOO_ROUTES}}
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    want = {}
    for route in GLOO_ROUTES:
        _set_mode(monkeypatch, ROUTES[route][1])
        single = serving.Retriever(model, device="cpu", **_kw(route))
        single.index(PackedVideos(feats=feats, mask=mask, ids=ids))
        want[route] = single.search(qf, qm, K)
        single.save_index(str(tmp_path / f"single_{route}"))
    ranks = _run_workers(2, ["serve", tmp_path])
    assert [r["rank"] for r in ranks] == [0, 1]
    for route in GLOO_ROUTES:
        _set_mode(monkeypatch, ROUTES[route][1])
        for rank in ranks:
            for what in ("built", "loaded"):
                got = rank[route][what]
                np.testing.assert_array_equal(got["ids"], want[route][1])
                np.testing.assert_array_equal(
                    np.float32(got["scores"]), want[route][0])
        # the group's artifact: the single-device arrays, in one process
        for name in os.listdir(tmp_path / f"single_{route}"):
            if name.endswith(".npy"):
                np.testing.assert_array_equal(
                    np.load(tmp_path / f"single_{route}" / name),
                    np.load(tmp_path / f"group_{route}" / name))
        r = serving.Retriever(model, device="cpu", **_kw(route))
        r.load_index(str(tmp_path / f"group_{route}"))
        _search_same(r, qf, qm, want[route], f"group artifact {route}")
    assert index_io.read_meta(str(tmp_path / "group_exact"))[
        "n_videos"] == n_vid
