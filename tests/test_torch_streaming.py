"""The port's corpus streaming against the JAX package's: the streaming eval
(`run_retrieval_eval` on its streaming route, and `stream_score_matrices`,
with and without score_quant), the engine policy under a memory budget and
the route table (`eval_plan`), and the raw-store serving search
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


def _run(model, videos, queries, stream, **kw):
    """run_retrieval_eval on the CPU at query batches of 8 and context
    batches of 8: stream -1 resident, > 0 streaming with that block."""
    cfg = EvalConfig(eval_query_bsz=8, eval_context_bsz=8,
                     corpus_stream_bsz=stream, **kw)
    return evaluate.run_retrieval_eval(model, videos, queries, cfg,
                                       device="cpu")


@pytest.mark.parametrize("block", [5, 16, 37, 64])
def test_streaming_matches_jax_and_resident(eval_models, block):
    """Blocks that divide the corpus and blocks that do not, one block and
    a block larger than the corpus: the JAX streaming engine's metrics and
    the port's resident engine's."""
    jmodel, params, (jv, jq), model, (videos, queries) = eval_models
    want = jax_eval.eval_retrieval_streaming(
        jmodel, params, jv, jq, corpus_block=block, query_bsz=8)
    got = _run(model, videos, queries, block)
    _assert_metrics(got, want)
    _assert_metrics(got, _run(model, videos, queries, -1))


def test_streaming_quantized_matches_jax_and_resident(eval_models):
    """score_quant: the towers emit each block's int8 rows; the same
    metrics as the JAX streaming int8 engine and the port's resident int8
    engine, and the same int8 scores as the resident index's columns."""
    jmodel, params, (jv, jq), model, (videos, queries) = eval_models
    want = jax_eval.eval_retrieval_streaming(
        jmodel, params, jv, jq, corpus_block=10, query_bsz=8,
        score_quant=True)
    got = _run(model, videos, queries, 10, score_quant=True)
    _assert_metrics(got, want)
    _assert_metrics(got, _run(model, videos, queries, -1, score_quant=True))
    s_i, s_e = evaluate.stream_score_matrices(model, videos, queries, 10, 8,
                                              "cpu", score_quant=True)
    r_i, r_e = evaluate.score_matrices(model, videos, queries, 8, 8, "cpu",
                                       score_quant=True)
    torch.testing.assert_close(s_i, r_i[:, :N_VID], atol=0, rtol=0)
    if r_e is not None:
        torch.testing.assert_close(s_e, r_e[:, :N_VID], atol=0, rtol=0)


def _score(queries, score_i, score_e):
    """Both branches' scores of the pooled `queries` by `block_scorers`'
    pair."""
    return score_i(queries[0]), (score_e(queries[1]) if score_e else None)


def test_encode_all_queries_and_block_scores_match_jax(eval_models):
    """The streaming engine's parts: every query's pooled vectors, one
    block's scores (exact, against the JAX block scorer, and int8: the
    block scorers take the int8 index `embed_corpus` builds as they take
    frames)."""
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
    g_i, g_e = _score(got, *evaluate.block_scorers(
        ci[:16], None if ce is None else ce[:16], mask))
    assert (g_e is None) == (w_e is None)
    for g, w in ((g_i, w_i), (g_e, w_e)):
        if w is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                       rtol=0)
    q8_i, q8_e, bias = evaluate.embed_corpus(model, videos, 16, "cpu",
                                             score_quant=True)
    s8_i, s8_e = _score(got, *evaluate.block_scorers(
        q8_i[:16], None if q8_e is None else q8_e[:16], bias[:16]))
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


@pytest.mark.parametrize("stream,budget,mesh_size,plan", [
    (0, 1024, 0, (min(evaluate.DEFAULT_STREAM_BLOCK, N_VID), 64)),
    (0, 1 << 40, 0, (0, evaluate.RESIDENT_QUERY_BSZ)),
    (0, None, 0, (0, evaluate.RESIDENT_QUERY_BSZ)),
    (-1, 1024, 0, (0, evaluate.RESIDENT_QUERY_BSZ)),
    (9, None, 0, (9, 64)),
    (0, 1024, 3, (min(evaluate.DEFAULT_STREAM_BLOCK, N_VID), 64)),
    (-1, None, 2, (0, 64)),
    (9, None, 2, (9, 64))],
    ids=["auto_small_budget", "auto_large_budget", "auto_no_budget",
         "resident", "stream", "mesh_auto_small_budget", "mesh_resident",
         "mesh_stream"])
def test_eval_plan_routes(eval_models, monkeypatch, stream, budget,
                          mesh_size, plan):
    """The route table, taken once by `eval_plan` as the JAX package's
    router takes it: corpus_stream_bsz 0 = auto (streams with min(2048, Nv)
    under a $DLDKD_EVAL_MEM_BUDGET too small for the resident estimate,
    resident under a large one or none), -1 = resident, 9 = stream with 9;
    the query block at least RESIDENT_QUERY_BSZ on the resident
    single-device route and at least 64 on the others. run_retrieval_eval
    runs the planned engine at the planned blocks, and the metrics are the
    JAX router's (the resident engine's on a mesh)."""
    from dldkd_tpu_torch.parallel import eval_shard, make_mesh

    jmodel, params, (jv, jq), model, (videos, queries) = eval_models
    if budget is None:
        monkeypatch.delenv("DLDKD_EVAL_MEM_BUDGET", raising=False)
    else:
        monkeypatch.setenv("DLDKD_EVAL_MEM_BUDGET", str(budget))
    cfg = EvalConfig(eval_query_bsz=8, eval_context_bsz=8,
                     corpus_stream_bsz=stream)
    assert evaluate.eval_plan(N_VID, N_Q, model.config, cfg, mesh_size,
                              evaluate.device_memory_budget("cpu")) == plan

    calls = []
    for mod, name, blocks in (
            (evaluate, "score_matrices", lambda a: (0, a[4])),
            (evaluate, "stream_score_matrices", lambda a: a[3:5]),
            (eval_shard, "sharded_score_matrices", lambda a: (a[6], a[4]))):
        def spy(*a, _real=getattr(mod, name), _blocks=blocks, **k):
            calls.append(tuple(_blocks(a)))
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    mesh = make_mesh(devices=["cpu"] * mesh_size) if mesh_size else None
    out = evaluate.run_retrieval_eval(model, videos, queries, cfg, mesh=mesh,
                                      device="cpu")
    assert calls == [plan]
    if mesh is None:
        jcfg = JaxEvalConfig(eval_query_bsz=8, eval_context_bsz=8,
                             corpus_stream_bsz=stream)
        want = jax_eval.run_retrieval_eval(jmodel, params, jv, jq, jcfg)
    else:
        monkeypatch.undo()
        want = _run(model, videos, queries, -1)
    _assert_metrics(out, want)


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
