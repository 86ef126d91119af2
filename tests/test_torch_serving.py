"""The port's serving `Retriever` and CLI against the JAX package's, on the
clustered near-tie corpus of tests/test_rescore.py: near-duplicate videos
1e-3 apart, below the int8 grid and above f32 resolution, so int8 scores
tie inside a cluster and only exact scoring ranks its members.

The JAX Retriever runs with mesh=None (the suite's conftest makes 8 CPU
devices). Both packages are pinned to the same stage-2 engine with
DLDKD_DENSE_RESCORE, so parity never rests on either cost model. Ids must
be equal; scores agree to 1e-5 (f32, the same operations summed in
another order).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dldkd_tpu.serving as jax_serving
from dldkd_tpu import checkpoint as jax_ckpt
from dldkd_tpu.config import ModelConfig as JaxModelConfig
from dldkd_tpu.data.ingest import PackedVideos as JaxPackedVideos
from dldkd_tpu.data.ingest import pack_query_rows as jax_pack_query_rows
from dldkd_tpu.data.synthetic import generate_dataset as jax_generate
from dldkd_tpu.models import DLDKD as JaxDLDKD
from dldkd_tpu.train import init_params
from dldkd_tpu_torch import serving
from dldkd_tpu_torch.config import ModelConfig
from dldkd_tpu_torch.convert import load_jax_params
from dldkd_tpu_torch.data.ingest import PackedVideos, pack_query_rows
from dldkd_tpu_torch.evaluate import embed_corpus
from dldkd_tpu_torch.models import DLDKD
from dldkd_tpu_torch.ops.fast_eval import encode_query_best

N_CLUSTERS, PER_CLUSTER, L, DV, DQ = 4, 16, 8, 16, 12
N_VID = N_CLUSTERS * PER_CLUSTER
N_Q, K = 12, 5
SCORE_TOL = 1e-5
_DIMS = dict(visual_input_size=DV, query_input_size=DQ, inheritance_hidden=8,
             exploration_hidden=8, max_ctx_l=L, max_desc_l=4, n_heads=2,
             double_branch=True, label_style="soft")


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
def clustered():
    """tests/test_rescore.py's corpus, in both packages' containers."""
    jcfg = JaxModelConfig(**_DIMS)
    jmodel = JaxDLDKD(config=jcfg)
    params = init_params(jmodel, jcfg, 0)
    model = load_jax_params(DLDKD(ModelConfig(**_DIMS)),
                            jax.tree.map(np.asarray, params)).eval()
    rng = np.random.RandomState(7)
    bases = rng.randn(N_CLUSTERS, L, DV).astype(np.float32)
    feats = np.stack([bases[i % N_CLUSTERS]
                      + 1e-3 * rng.randn(L, DV).astype(np.float32)
                      for i in range(N_VID)])
    mask = np.ones((N_VID, L), np.float32)
    ids = [f"v{i}" for i in range(N_VID)]
    qf = rng.randn(N_Q, 4, DQ).astype(np.float32)
    qm = np.ones((N_Q, 4), np.float32)
    return (jmodel, params, JaxPackedVideos(feats=feats, mask=mask, ids=ids),
            model, PackedVideos(feats=feats, mask=mask, ids=ids), qf, qm)


def _jax_search(clustered, k=K, query_bsz=8, **kw):
    jmodel, params, jvideos, _, _, qf, qm = clustered
    # the jitted search programs read DLDKD_DENSE_RESCORE when they trace:
    # drop their caches so each mode traces anew
    for fn in (jax_serving._search_jit, jax_serving._search_q8_jit):
        fn.clear_cache()
    r = jax_serving.Retriever(jmodel, params, query_bsz=query_bsz, **kw)
    r.mesh = None  # the single-device path
    r.index(jvideos)
    return r.search(qf, qm, k=k)


def _port(clustered, query_bsz=8, **kw):
    _, _, _, model, videos, _, _ = clustered
    r = serving.Retriever(model, query_bsz=query_bsz, device="cpu", **kw)
    r.index(videos)
    return r


def _assert_same(got, want):
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=SCORE_TOL,
                               rtol=0)


def test_exact_search_matches_jax(clustered):
    _, _, _, _, _, qf, qm = clustered
    got = _port(clustered).search(qf, qm, k=K)
    assert got[0].dtype == np.float32 and got[1].shape == (N_Q, K)
    _assert_same(got, _jax_search(clustered))


@pytest.mark.parametrize("mode", ["never", "always"])
def test_two_stage_search_matches_jax(clustered, monkeypatch, mode):
    """Two-stage search with the gather (never) or the dense exact scorer
    (always) in stage 2: the JAX package's ids, which on this corpus are
    also the exact path's."""
    _, _, _, _, _, qf, qm = clustered
    monkeypatch.setenv("DLDKD_DENSE_RESCORE", mode)
    got = _port(clustered, score_quant=True).search(qf, qm, k=K)
    _assert_same(got, _jax_search(clustered, score_quant=True))
    exact = _port(clustered).search(qf, qm, k=K)
    np.testing.assert_array_equal(got[1], exact[1])


def test_int8_only_search_matches_jax_ties_included(clustered):
    """int8-only ranks: clusters tie on the int8 grid and break by video
    id, as jax.lax.top_k breaks them."""
    _, _, _, _, _, qf, qm = clustered
    r = _port(clustered, score_quant=True, rescore=False)
    assert r.ctx_inher is None and r.q8_inher.dtype == torch.int8
    got = r.search(qf, qm, k=K)
    _assert_same(got, _jax_search(clustered, score_quant=True,
                                  rescore=False))
    exact = _port(clustered).search(qf, qm, k=K)
    assert (got[1] != exact[1]).any(), "no int8 ties on this corpus"
    # equal int8 scores inside a row come with ascending ids
    s, i = got
    tie = s[:, 1:] == s[:, :-1]
    assert tie.any() and np.all(i[:, 1:][tie] > i[:, :-1][tie])


def test_k_larger_than_corpus_and_ragged_batches(clustered, monkeypatch):
    """k past the corpus clips to it; a query count that is not a multiple
    of the batch gives the results of one whole batch."""
    _, _, _, _, _, qf, qm = clustered
    monkeypatch.setenv("DLDKD_DENSE_RESCORE", "never")
    for kw in (dict(), dict(score_quant=True)):
        got = _port(clustered, query_bsz=5, **kw).search(qf, qm, k=100)
        assert got[1].shape == (N_Q, N_VID)
        whole = _port(clustered, query_bsz=N_Q, **kw).search(qf, qm, k=100)
        np.testing.assert_array_equal(got[1], whole[1])
        np.testing.assert_array_equal(got[0], whole[0])
        _assert_same(got, _jax_search(clustered, k=100, query_bsz=5, **kw))


def test_search_ids(clustered):
    _, _, _, _, videos, qf, qm = clustered
    r = _port(clustered)
    scores, idx = r.search(qf, qm, k=3)
    rows = r.search_ids(qf, qm, k=3)
    assert len(rows) == N_Q and all(len(row) == 3 for row in rows)
    for row, ri, rs in zip(rows, idx, scores):
        assert [v for v, _ in row] == [videos.ids[j] for j in ri]
        assert [s for _, s in row] == [float(s) for s in rs]
    with pytest.raises(RuntimeError, match="index"):
        serving.Retriever(r.model, device="cpu").search(qf, qm)


def test_topk_lowest_index_breaks_ties_like_jax():
    rng = np.random.RandomState(2)
    scores = np.round(rng.rand(6, 40), 1).astype(np.float32)  # many ties
    scores[0] = 0.5
    want_s, want_i = jax.lax.top_k(jnp.asarray(scores), 9)
    got_s, got_i = serving.topk_lowest_index(torch.from_numpy(scores), 9)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_i[0].tolist() == list(range(9))


def test_rescore_stage2_and_two_stage_topk_match_jax(clustered, monkeypatch):
    """The stage-2 engines and the per-call two-stage top-k against the
    JAX functions on the same encoded corpus, each engine pinned; the two
    engines return the same ids."""
    jmodel, params, jvideos, model, videos, qf, qm = clustered
    from dldkd_tpu.evaluate import embed_corpus as jax_embed
    from dldkd_tpu.ops.fast_eval import encode_query_best as jax_encode

    ci, ce, vm = embed_corpus(model, videos, 16, "cpu")
    q_i, q_e = encode_query_best(model, torch.from_numpy(qf),
                                 torch.from_numpy(qm))
    jci, jce, jvm = jax_embed(jmodel, params, jvideos, 16)
    jq_i, jq_e = jax_encode(params, jmodel.config, jnp.asarray(qf),
                            jnp.asarray(qm))
    fw = serving.Retriever(model, device="cpu").fusion
    jfw = jnp.asarray([0.7, 0.3], jnp.float32)
    ids = []
    for mode in ("never", "always"):
        monkeypatch.setenv("DLDKD_DENSE_RESCORE", mode)
        got = serving._two_stage_topk(q_i, q_e, ci, ce, vm, fw, K, K)
        want = jax_serving._two_stage_topk(jq_i, jq_e, jci, jce, jvm, jfw,
                                           K, K)
        _assert_same([t.numpy() for t in got], want)
        ids.append(got[1])
    assert torch.equal(ids[0], ids[1])


def test_unported_serving_routes_raise(clustered):
    """Every route is ported: the raw store (tests/test_torch_streaming.py),
    index artifacts, prewarm, warm start and the kernel-library directory
    (tests/test_torch_index_artifacts.py), a mesh
    (tests/test_torch_serving_mesh.py). A mesh that is not a
    `parallel.Mesh`, or a device other than the mesh's first, is refused
    on either store. The CLI still refuses, at argparse time, a run with
    no queries and no --save_index, and one with no dataset to index."""
    from dldkd_tpu_torch.parallel import make_mesh

    _, _, _, model, _, _, _ = clustered
    for kw in (dict(mesh=object()), dict(index_store="raw", mesh=object()),
               dict(mesh=object(), warm_start=True, score_quant=True)):
        with pytest.raises(TypeError, match="parallel.Mesh"):
            serving.Retriever(model, device="cpu", **kw)
    for kw in (dict(), dict(index_store="raw")):
        with pytest.raises(ValueError, match="first device"):
            serving.Retriever(model, device="cuda", **kw,
                              mesh=make_mesh(devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="index_store"):
        serving.Retriever(model, device="cpu", index_store="bogus")
    base = ["--model_dir", "/nonexistent", "--root_path", "/nonexistent",
            "--collection", "c", "--visual_feature", "v", "--queries",
            "q.npz"]
    with pytest.raises(SystemExit):   # no queries
        serving.main(base[:-2])
    with pytest.raises(SystemExit):   # no dataset to index
        serving.main(["--model_dir", "/nonexistent", "--queries", "q.npz"])
    with pytest.raises(SystemExit):   # caption-file queries need the dataset
        serving.main(["--model_dir", "/nonexistent", "--load_index", "/i",
                      "--queries", "captions.txt"])


def test_pack_query_rows_pad_to_multiple_matches_jax():
    rng = np.random.RandomState(0)
    store = {f"c{i}": rng.randn(1, 3 + i, 6).astype(np.float32)
             for i in range(4)}
    for mult in (1, 8):
        got = pack_query_rows(store, list(store), 5, pad_to_multiple=mult)
        want = jax_pack_query_rows(store, list(store), 5,
                                   pad_to_multiple=mult)
        assert got[0].shape[1] == (5 if mult == 1 else 8)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("route", [
    [], ["--score_quant", "--no_rescore"],
    ["--index_store", "raw", "--stream_block", "3"],
    ["--index_store", "raw", "--stream_block", "3", "--score_quant",
     "--no_rescore"]], ids=["exact", "int8", "raw", "raw_int8"])
def test_serving_cli_matches_jax(tmp_path, monkeypatch, route):
    """serving.main on a synthetic dataset writes the JAX CLI's JSON lines,
    on the encoded and on the raw store (a stream block that does not
    divide the 7 videos): the same captions in the same order with the
    same video ids, scores within 1e-5. The JAX CLI reads the HDF5 query store, the port its .npz
    twin."""
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
    common = ["--model_dir", str(run_dir), "--root_path", root,
              "--collection", "synthetic", "--visual_feature", "i3d",
              "--k", "4"] + route
    monkeypatch.setattr(jax, "device_count", lambda: 1)  # no mesh
    for fn in (jax_serving._search_jit, jax_serving._search_q8_jit,
               jax_serving._encoded_block_topk_jit):
        fn.clear_cache()
    jax_serving.main(common + ["--queries", h5,
                               "--out", str(tmp_path / "jax.jsonl")])
    serving.main(common + ["--queries", npz, "--torch_device", "cpu",
                           "--out", str(tmp_path / "port.jsonl")])
    want = [json.loads(x) for x in open(tmp_path / "jax.jsonl")]
    got = [json.loads(x) for x in open(tmp_path / "port.jsonl")]
    assert len(got) == len(want) > 7
    for g, w in zip(got, want):
        assert g["cap_id"] == w["cap_id"]
        assert [v for v, _ in g["topk"]] == [v for v, _ in w["topk"]]
        np.testing.assert_allclose([s for _, s in g["topk"]],
                                   [s for _, s in w["topk"]],
                                   atol=SCORE_TOL, rtol=0)


# ------------------------------------------------------- query staging

def _host_padded_batches(self, q_feats, q_mask):
    """The staging that the host slots replaced, kept as the reference:
    each batch zero-padded to query_bsz rows by np.concatenate on the
    host, then copied to the device."""
    bsz = self.query_bsz
    for start in range(0, q_feats.shape[0], bsz):
        f = np.asarray(q_feats[start:start + bsz], np.float32)
        m = np.asarray(q_mask[start:start + bsz], np.float32)
        pad = bsz - f.shape[0]
        if pad:
            f = np.concatenate([f, np.zeros((pad,) + f.shape[1:], f.dtype)])
            m = np.concatenate([m, np.zeros((pad,) + m.shape[1:], m.dtype)])
        yield (torch.from_numpy(f).to(self.device),
               torch.from_numpy(m).to(self.device))


STORES = {"encoded": dict(), "q8": dict(score_quant=True),
          "raw": dict(index_store="raw", stream_block=24)}


@pytest.fixture(scope="module")
def staged(clustered):
    """One retriever a store at serving's batch of 256, and 600 ragged
    queries."""
    rng = np.random.RandomState(11)
    qf = rng.randn(600, 4, DQ).astype(np.float32)
    qm = (np.arange(4)[None] < rng.randint(1, 5, 600)[:, None]
          ).astype(np.float32)
    return {name: _port(clustered, query_bsz=256, **kw)
            for name, kw in STORES.items()}, qf, qm


def _host_padded_search(r, qf, qm, k=K):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(serving.Retriever, "_query_batches",
                   _host_padded_batches)
        return r.search(qf, qm, k)


def _assert_bitwise(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("n", [1, 100, 255, 256, 257, 600])
@pytest.mark.parametrize("store", list(STORES))
def test_staged_batches_match_host_padding(staged, store, n):
    """Batches staged through the host slots and padded on the device
    give the host-padded batches' scores and ids bitwise, on every store,
    for a batch of one real row, partial and full batches and several
    batches a search."""
    retrievers, qf, qm = staged
    r = retrievers[store]
    got = r.search(qf[:n], qm[:n], k=K)
    assert got[1].shape == (n, K)
    _assert_bitwise(got, _host_padded_search(r, qf[:n], qm[:n]))


def test_no_stale_rows_after_a_larger_search(clustered, staged,
                                             monkeypatch):
    """A search of 600 queries (three batches, both slots) then one of 3:
    the second's device batch holds its 3 rows and zeros, nothing of the
    first, and its results are a fresh retriever's."""
    retrievers, qf, qm = staged
    r = retrievers["encoded"]
    r.search(qf, qm, k=K)
    seen = []
    real = serving.Retriever._search_batch

    def spy(self, f, m, k):
        seen.append((f.clone(), m.clone()))
        return real(self, f, m, k)

    monkeypatch.setattr(serving.Retriever, "_search_batch", spy)
    got = r.search(qf[-3:], qm[-3:], k=K)
    (f, m), = seen
    assert f.shape == (256, 4, DQ) and m.shape == (256, 4)
    assert torch.equal(f[:3], torch.from_numpy(qf[-3:]))
    assert torch.equal(m[:3], torch.from_numpy(qm[-3:]))
    assert not f[3:].any() and not m[3:].any()
    monkeypatch.setattr(serving.Retriever, "_search_batch", real)
    fresh = _port(clustered, query_bsz=256)
    _assert_bitwise(got, fresh.search(qf[-3:], qm[-3:], k=K))


def test_query_length_changes_across_searches(staged):
    """Searches of 2, then 4 (the slots regrow), then 3 tokens: each the
    host-padded batches' results."""
    retrievers, qf, qm = staged
    r = retrievers["encoded"]
    for lq in (2, 4, 3):
        f = np.ascontiguousarray(qf[:300, :lq])
        m = np.ascontiguousarray(qm[:300, :lq])
        m[:, 0] = 1.0
        _assert_bitwise(r.search(f, m, k=K), _host_padded_search(r, f, m))


def test_callers_array_changed_in_place_gives_the_new_answer(staged):
    """The slots are the server's buffers, not a cache: a search after
    the caller rewrote its array in place answers the new queries."""
    retrievers, qf, qm = staged
    r = retrievers["encoded"]
    f, m = qf[:40].copy(), qm[:40].copy()
    before = r.search(f, m, k=K)
    f[:] = qf[100:140]
    m[:] = qm[100:140]
    after = r.search(f, m, k=K)
    _assert_bitwise(after, r.search(qf[100:140], qm[100:140], k=K))
    assert (after[1] != before[1]).any()


def test_serving_spans_and_counters_under_a_profiler(staged, tmp_path):
    """Under a profiler a search of 600 queries records one serve/h2d
    span a batch, serve/topk and serve/d2h spans, the real rows' bytes
    handed over and the padding rows zeroed; with no profiler, nothing."""
    from dldkd_tpu_torch.utils import tracing

    retrievers, qf, qm = staged
    r = retrievers["encoded"]
    prof = tracing.start_profile(torch.device("cpu"))
    r.search(qf, qm, k=K)
    path = tracing.stop_profile(prof, str(tmp_path))
    names = [e.get("name") for e in json.load(open(path))["traceEvents"]]
    assert names.count("serve/h2d") == 3
    assert names.count("serve/topk") >= 3 and names.count("serve/d2h") >= 1
    assert tracing.counts() == {"serve.h2d_bytes": 600 * (4 * DQ + 4) * 4,
                                "serve.padded_rows": 3 * 256 - 600}
    r.search(qf, qm, k=K)
    assert tracing.counts()["serve.padded_rows"] == 3 * 256 - 600
