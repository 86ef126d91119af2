"""The port's corpus streaming against the JAX package's: the streaming eval
(`evaluate.eval_retrieval_streaming`, with and without score_quant), the
engine policy under a memory budget, and the raw-store serving search
(`Retriever(index_store='raw')`, its CLI).

The eval fixture is tests/test_streaming_eval.py's (awkward sizes, ragged
video masks); the serving fixture is test_torch_serving.py's clustered
near-tie corpus, with a stream block that does not divide it. Metric
dicts must agree within 1e-9 (ranks equal); serving ids must be equal and
scores within SCORE_TOL (f32, the same operations summed in another
order). The JAX Retriever runs with mesh=None (the suite's conftest makes
8 CPU devices), and both packages are pinned to one stage-2 engine with
DLDKD_DENSE_RESCORE.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import dldkd_tpu.evaluate as jax_eval
import dldkd_tpu.serving as jax_serving
from dldkd_tpu.config import EvalConfig as JaxEvalConfig
from dldkd_tpu.config import ModelConfig as JaxModelConfig
from dldkd_tpu.data.ingest import PackedQueries as JaxPackedQueries
from dldkd_tpu.data.ingest import PackedVideos as JaxPackedVideos
from dldkd_tpu.models import DLDKD as JaxDLDKD
from dldkd_tpu.train import init_params
from dldkd_tpu_torch import evaluate, serving
from dldkd_tpu_torch.config import EvalConfig, ModelConfig
from dldkd_tpu_torch.convert import load_jax_params
from dldkd_tpu_torch.data.ingest import PackedQueries, PackedVideos
from dldkd_tpu_torch.models import DLDKD
from dldkd_tpu_torch.ops.kernels.query_tower import sequences_per_launch

from tests.test_torch_serving import (K, N_VID as SERVE_VIDEOS, SCORE_TOL,
                                      _assert_same, _jax_search, _port)
from tests.test_torch_serving import _torch_numerics  # noqa: F401
from tests.test_torch_serving import clustered  # noqa: F401

L, DV, DQ, LQ = 8, 16, 12, 4
N_VID, N_Q = 37, 23
STREAM_BLOCK = 24   # does not divide the serving corpus of 64 videos


def _data(seed=0):
    rng = np.random.RandomState(seed)
    vmask = np.ones((N_VID, L), np.float32)
    vmask[rng.rand(N_VID, L) < 0.2] = 0.0
    vmask[:, 0] = 1.0
    vf = rng.randn(N_VID, L, DV).astype(np.float32)
    ids = [f"v{i}" for i in range(N_VID)]
    qf = rng.randn(N_Q, LQ, DQ).astype(np.float32)
    qm = np.ones((N_Q, LQ), np.float32)
    gt = [ids[rng.randint(N_VID)] for _ in range(N_Q)]
    caps = [f"{v}#enc#{i}" for i, v in enumerate(gt)]
    return ((JaxPackedVideos(feats=vf, mask=vmask, ids=ids),
             JaxPackedQueries(feats=qf, mask=qm, cap_ids=caps,
                              video_ids=gt)),
            (PackedVideos(feats=vf, mask=vmask, ids=ids),
             PackedQueries(feats=qf, mask=qm, cap_ids=caps, video_ids=gt)))


@pytest.fixture(scope="module", params=[True, False],
                ids=["double", "single"])
def eval_models(request):
    dims = dict(visual_input_size=DV, query_input_size=DQ,
                inheritance_hidden=8, exploration_hidden=8, max_ctx_l=L,
                max_desc_l=LQ, n_heads=2, double_branch=request.param,
                label_style="soft")
    jcfg = JaxModelConfig(**dims)
    jmodel = JaxDLDKD(config=jcfg)
    params = init_params(jmodel, jcfg, 0)
    model = load_jax_params(DLDKD(ModelConfig(**dims)),
                            jax.tree.map(np.asarray, params)).eval()
    jax_data, data = _data()
    return jmodel, params, jax_data, model, data


def _assert_metrics(got, want):
    assert got.keys() == want.keys()
    for branch in want:
        for k, v in want[branch].items():
            assert got[branch][k] == pytest.approx(v, abs=1e-9), (branch, k)


@pytest.mark.parametrize("block", [5, 16, 37, 64])
def test_streaming_matches_jax_and_resident(eval_models, block):
    """Blocks that divide the corpus and blocks that do not, one block and
    a block larger than the corpus: the JAX streaming engine's metrics and
    the port's resident engine's."""
    jmodel, params, (jv, jq), model, (videos, queries) = eval_models
    want = jax_eval.eval_retrieval_streaming(
        jmodel, params, jv, jq, corpus_block=block, query_bsz=8)
    got = evaluate.eval_retrieval_streaming(model, videos, queries,
                                            corpus_block=block, query_bsz=8,
                                            device="cpu")
    _assert_metrics(got, want)
    resident = evaluate.eval_retrieval(model, videos, queries,
                                       context_bsz=8, query_bsz=8,
                                       corpus_stream_bsz=0, device="cpu")
    _assert_metrics(got, resident)


def test_streaming_quantized_matches_jax_and_resident(eval_models):
    """score_quant: the towers emit each block's int8 rows; the same
    metrics as the JAX streaming int8 engine and the port's resident int8
    engine, and the same int8 scores as the resident index's columns."""
    jmodel, params, (jv, jq), model, (videos, queries) = eval_models
    want = jax_eval.eval_retrieval_streaming(
        jmodel, params, jv, jq, corpus_block=10, query_bsz=8,
        score_quant=True)
    got = evaluate.eval_retrieval_streaming(model, videos, queries,
                                            corpus_block=10, query_bsz=8,
                                            score_quant=True, device="cpu")
    _assert_metrics(got, want)
    _assert_metrics(got, evaluate.eval_retrieval(
        model, videos, queries, context_bsz=8, query_bsz=8,
        score_quant=True, corpus_stream_bsz=0, device="cpu"))
    s_i, s_e = evaluate.stream_score_matrices(model, videos, queries, 10, 8,
                                              "cpu", score_quant=True)
    r_i, r_e = evaluate.score_matrices(model, videos, queries, 8, 8, "cpu",
                                       score_quant=True)
    torch.testing.assert_close(s_i, r_i[:, :N_VID], atol=0, rtol=0)
    if r_e is not None:
        torch.testing.assert_close(s_e, r_e[:, :N_VID], atol=0, rtol=0)


def test_encode_all_queries_and_block_scores_match_jax(eval_models):
    """The streaming engine's parts: every query's pooled vectors, one
    block's scores (exact and int8)."""
    jmodel, params, (jv, jq), model, (videos, queries) = eval_models
    want = jax_eval.encode_all_queries(jmodel, params, jq, query_bsz=8)
    got = evaluate.encode_all_queries(model, queries, query_bsz=8,
                                      device="cpu")
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                       rtol=0)
    jci, jce = jax_eval._encode_context_jit(jmodel, params, jv.feats[:16],
                                            jv.mask[:16])
    ci, ce, _ = evaluate.embed_corpus(model, videos, 16, "cpu")
    mask = torch.from_numpy(videos.mask[:16])
    w_i, w_e = jax_eval.score_encoded_block(*want, jci, jce, jv.mask[:16])
    g_i, g_e = evaluate.score_encoded_block(*got, ci[:16],
                                            None if ce is None else ce[:16],
                                            mask)
    assert (g_e is None) == (w_e is None)
    for g, w in ((g_i, w_i), (g_e, w_e)):
        if w is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                       rtol=0)
    q8_i, q8_e = evaluate.encode_context_q8(
        model, torch.from_numpy(videos.feats[:16]), mask)
    s8_i, s8_e = evaluate.score_q8_block(*got, q8_i, q8_e, mask)
    assert s8_i.shape == (N_Q, 16) and (s8_e is None) == (ce is None)


def test_auto_stream_block_policy(monkeypatch):
    """The policy and its memory model are the JAX package's: int8 halves
    or quarters the resident index, so a budget between the two estimates
    streams the exact engine and keeps the int8 one resident; a device
    that reports no budget (the CPU) stays resident."""
    dims = dict(visual_input_size=16, query_input_size=12,
                inheritance_hidden=384, exploration_hidden=384,
                max_ctx_l=128, max_desc_l=8, n_heads=2, double_branch=True,
                dtype="float32")
    mcfg, jcfg = ModelConfig(**dims), JaxModelConfig(**dims)
    n_vid, n_q = 20000, 1000
    for quant in (False, True):
        assert evaluate.resident_eval_bytes(n_vid, n_q, mcfg, quant) == \
            jax_eval.resident_eval_bytes(n_vid, n_q, jcfg, quant)
    exact = evaluate.resident_eval_bytes(n_vid, n_q, mcfg)
    quant = evaluate.resident_eval_bytes(n_vid, n_q, mcfg, score_quant=True)
    budget = (exact + quant) // 2
    for n_dev in (1, 4):
        for q in (False, True):
            got = evaluate.auto_stream_block(n_vid, n_q, mcfg, n_dev, budget,
                                             score_quant=q)
            assert got == jax_eval.auto_stream_block(
                n_vid, n_q, jcfg, n_dev, budget, score_quant=q)
    assert evaluate.auto_stream_block(n_vid, n_q, mcfg, budget=budget) == \
        evaluate.DEFAULT_STREAM_BLOCK == 2048
    assert evaluate.auto_stream_block(n_vid, n_q, mcfg, budget=budget,
                                      score_quant=True) == 0
    assert evaluate.auto_stream_block(100, n_q, mcfg, budget=1) == 100
    monkeypatch.delenv("DLDKD_EVAL_MEM_BUDGET", raising=False)
    assert evaluate.auto_stream_block(n_vid, n_q, mcfg, device="cpu") == 0


def _spy_streaming(monkeypatch):
    calls = []
    real = evaluate.eval_retrieval_streaming

    def spy(*a, **k):
        calls.append((k.get("corpus_block"), k.get("query_bsz")))
        return real(*a, **k)

    monkeypatch.setattr(evaluate, "eval_retrieval_streaming", spy)
    return calls


def test_eval_retrieval_routes_by_budget(eval_models, monkeypatch):
    """corpus_stream_bsz=None picks the engine from $DLDKD_EVAL_MEM_BUDGET:
    a budget too small for the resident estimate streams with
    min(2048, Nv) and the same metrics; a large one stays resident; 0
    forces resident, > 0 streams with that block."""
    _, _, _, model, (videos, queries) = eval_models
    calls = _spy_streaming(monkeypatch)
    ref = evaluate.eval_retrieval(model, videos, queries, query_bsz=8,
                                  corpus_stream_bsz=0, device="cpu")
    monkeypatch.setenv("DLDKD_EVAL_MEM_BUDGET", str(1024))
    out = evaluate.eval_retrieval(model, videos, queries, query_bsz=8,
                                  device="cpu")
    assert calls == [(min(evaluate.DEFAULT_STREAM_BLOCK, N_VID), 8)]
    _assert_metrics(out, ref)
    monkeypatch.setenv("DLDKD_EVAL_MEM_BUDGET", str(1 << 40))
    evaluate.eval_retrieval(model, videos, queries, query_bsz=8,
                            device="cpu")
    monkeypatch.setenv("DLDKD_EVAL_MEM_BUDGET", str(1024))
    evaluate.eval_retrieval(model, videos, queries, query_bsz=8,
                            corpus_stream_bsz=0, device="cpu")
    assert len(calls) == 1
    out = evaluate.eval_retrieval(model, videos, queries, query_bsz=8,
                                  corpus_stream_bsz=9, device="cpu")
    assert calls[-1] == (9, 8)
    _assert_metrics(out, ref)


def test_run_retrieval_eval_router(eval_models, monkeypatch):
    """The CLIs' entry point, routed as the JAX package's routes it: 0 = auto
    (streams under a small budget, with query batches of at least 64),
    -1 = resident, 9 = stream with 9; the JAX router's metrics."""
    jmodel, params, (jv, jq), model, (videos, queries) = eval_models
    calls = _spy_streaming(monkeypatch)
    cfg = EvalConfig(eval_query_bsz=8, eval_context_bsz=8)
    jcfg = JaxEvalConfig(eval_query_bsz=8, eval_context_bsz=8)
    monkeypatch.setenv("DLDKD_EVAL_MEM_BUDGET", str(1024))
    out = evaluate.run_retrieval_eval(model, videos, queries, cfg,
                                      device="cpu")
    assert calls == [(min(evaluate.DEFAULT_STREAM_BLOCK, N_VID), 64)]
    _assert_metrics(out, jax_eval.run_retrieval_eval(jmodel, params, jv, jq,
                                                     jcfg))
    evaluate.run_retrieval_eval(model, videos, queries,
                                dataclasses.replace(cfg,
                                                    corpus_stream_bsz=-1),
                                device="cpu")
    assert len(calls) == 1
    out = evaluate.run_retrieval_eval(
        model, videos, queries, dataclasses.replace(cfg, corpus_stream_bsz=9),
        device="cpu")
    assert calls[-1] == (9, 64)
    _assert_metrics(out, jax_eval.run_retrieval_eval(
        jmodel, params, jv, jq, dataclasses.replace(jcfg,
                                                    corpus_stream_bsz=9)))


def test_sequences_per_launch_keeps_int32_and_grids():
    """The towers' per-launch cap: every buffer of the chain within int32
    elements and every grid dimension within 65,535, at the serving width
    (one launch per 2,048-video stream block) and at a narrow one."""
    def packed(hdim, heads, d, g_n):
        return {"dims": torch.tensor([hdim, heads, d]),
                "g1": torch.zeros(g_n, -(-hdim // 8) * 8)}

    cap = sequences_per_launch(128, 1024, packed(384, 4, 1024, 2))
    assert cap == 7281 and cap >= evaluate.DEFAULT_STREAM_BLOCK
    assert cap * 128 * 2 * 3 * 384 <= 2 ** 31 - 1
    assert (cap + 1) * 128 * 2 * 3 * 384 > 2 ** 31 - 1
    assert sequences_per_launch(128, 1024, packed(384, 4, 1024, 1)) == 14563
    # narrow widths: the grids bind, not int32
    assert sequences_per_launch(8, 16, packed(8, 2, 16, 2)) == 65535
    assert sequences_per_launch(128, 16, packed(8, 2, 16, 2)) == 32767
    assert sequences_per_launch(1 << 20, 1024, packed(384, 4, 1024, 2)) == 1


# ------------------------------------------------------------ raw store

def _raw(clustered, **kw):
    return _port(clustered, index_store="raw", stream_block=STREAM_BLOCK,
                 **kw)


@pytest.mark.parametrize("route,kw,mode", [
    ("exact", dict(), None),
    ("two_stage_gather", dict(score_quant=True), "never"),
    ("two_stage_dense", dict(score_quant=True), "always"),
    ("int8_only", dict(score_quant=True, rescore=False), None)])
def test_raw_search_matches_jax_raw(clustered, monkeypatch, route, kw,  # noqa: F811
                                    mode):
    """The raw store's ids equal the JAX raw store's, scores within
    SCORE_TOL, on every route; exact and two-stage also give the port's
    encoded store's ids."""
    _, _, _, _, _, qf, qm = clustered
    if mode:
        monkeypatch.setenv("DLDKD_DENSE_RESCORE", mode)
    for fn in (jax_serving._encoded_block_topk_jit,):
        fn.clear_cache()
    r = _raw(clustered, **kw)
    assert r.index_store == "raw" and r.raw_feats.shape[0] == 3 * STREAM_BLOCK
    assert r.ctx_inher is None and r.q8_inher is None
    got = r.search(qf, qm, k=K)
    _assert_same(got, _jax_search(clustered, index_store="raw",
                                  stream_block=STREAM_BLOCK, **kw))
    if route != "int8_only":
        encoded = _port(clustered, **kw).search(qf, qm, k=K)
        np.testing.assert_array_equal(got[1], encoded[1])


def test_raw_search_k_past_corpus_and_block(clustered):  # noqa: F811
    """k above the stream block and the corpus: the merge still returns
    the encoded store's whole ranking, padded videos never in it."""
    _, _, _, _, _, qf, qm = clustered
    got = _raw(clustered, query_bsz=5).search(qf, qm, k=100)
    assert got[1].shape == (len(qf), SERVE_VIDEOS)
    assert got[1].max() < SERVE_VIDEOS
    want = _port(clustered, query_bsz=5).search(qf, qm, k=100)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=SCORE_TOL, rtol=0)


def test_auto_index_store_builds_raw(clustered, monkeypatch):  # noqa: F811
    """Under a budget too small for the encoded index the auto policy
    takes the raw store, which indexes and searches."""
    _, _, _, model, videos, qf, qm = clustered
    monkeypatch.setenv("DLDKD_EVAL_MEM_BUDGET", "1")
    r = serving.Retriever(model, query_bsz=8, device="cpu", stream_block=16)
    assert r.auto_index_store(SERVE_VIDEOS) == "raw"
    r.index(videos)
    assert r.index_store == "raw"
    got = r.search(qf, qm, k=K)
    monkeypatch.delenv("DLDKD_EVAL_MEM_BUDGET")
    np.testing.assert_array_equal(got[1], _port(clustered).search(
        qf, qm, k=K)[1])
    with pytest.raises(ValueError, match="stream_block"):
        serving.Retriever(model, device="cpu", stream_block=0)
