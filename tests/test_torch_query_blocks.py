"""The resident eval's query loop at `evaluate.RESIDENT_QUERY_BSZ` queries a
launch, on the CPU (every kernel wrapper runs its plain version).

`run_retrieval_eval` on the resident route at eval_query_bsz 50 stages,
encodes and scores the queries in blocks of RESIDENT_QUERY_BSZ, the last
trimmed: one `encode_query_best` call (one query-tower launch) and one
scorer launch per branch for each block, read from the kernels/* spans
under torch.profiler. Its metric dicts equal the resident engine's at
50 queries a batch (`score_matrices`, then the eval's metric tail) on the
same inputs, and on the plain path the score matrices of the two widths
are bitwise equal. Imports no JAX.
"""

import json

import numpy as np
import pytest
import torch

from dldkd_tpu_torch import evaluate
from dldkd_tpu_torch.config import EvalConfig, ModelConfig
from dldkd_tpu_torch.data.ingest import PackedQueries, PackedVideos
from dldkd_tpu_torch.models import DLDKD
from dldkd_tpu_torch.utils import tracing

L, DV, DQ, LQ = 8, 16, 12, 6
N_VID, CONTEXT_BSZ, QUERY_BSZ = 37, 16, 50
BLOCK = evaluate.RESIDENT_QUERY_BSZ
N_Q = 2 * BLOCK + 76    # two whole blocks and a trimmed third
CPU = torch.device("cpu")


def _data():
    rng = np.random.RandomState(3)
    vmask = (np.arange(L)[None] < rng.randint(1, L + 1, N_VID)[:, None]
             ).astype(np.float32)
    qmask = (np.arange(LQ)[None] < rng.randint(1, LQ + 1, N_Q)[:, None]
             ).astype(np.float32)
    ids = [f"v{i}" for i in range(N_VID)]
    gt = [ids[rng.randint(N_VID)] for _ in range(N_Q)]
    return (PackedVideos(feats=rng.randn(N_VID, L, DV).astype(np.float32),
                         mask=vmask, ids=ids),
            PackedQueries(feats=rng.randn(N_Q, LQ, DQ).astype(np.float32),
                          mask=qmask,
                          cap_ids=[f"{v}#enc#{i}" for i, v in enumerate(gt)],
                          video_ids=gt))


def _model(double_branch: bool):
    cfg = ModelConfig(visual_input_size=DV, query_input_size=DQ,
                      inheritance_hidden=8, exploration_hidden=8,
                      max_ctx_l=L, max_desc_l=LQ, n_heads=2,
                      double_branch=double_branch, label_style="soft")
    return DLDKD(cfg).init_weights(torch.Generator().manual_seed(1)).eval()


def _kernel_spans(path) -> dict:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and e["name"].startswith("kernels/")]
    return {n: names.count(n) for n in set(names)}


@pytest.mark.parametrize("score_quant,double_branch", [
    (False, True), (False, False), (True, True)],
    ids=["f32", "f32_one_branch", "int8"])
def test_resident_route_scores_in_blocks(tmp_path, monkeypatch,
                                         score_quant, double_branch):
    model = _model(double_branch)
    videos, queries = _data()
    rows = []
    encode = evaluate.encode_query_best

    def counted(model, feats, mask, *args):
        rows.append(feats.shape[0])
        return encode(model, feats, mask, *args)

    monkeypatch.setattr(evaluate, "encode_query_best", counted)
    cfg = EvalConfig(eval_query_bsz=QUERY_BSZ, eval_context_bsz=CONTEXT_BSZ,
                     score_quant=score_quant, corpus_stream_bsz=-1)
    prof = tracing.start_profile(CPU)
    with torch.no_grad():
        got = evaluate.run_retrieval_eval(model, videos, queries, cfg,
                                          device=CPU)
    spans = _kernel_spans(tracing.stop_profile(prof, str(tmp_path)))

    assert rows == [BLOCK, BLOCK, N_Q - 2 * BLOCK]
    blocks, branches = len(rows), 2 if double_branch else 1
    scorer = "kernels/sim_max_int8" if score_quant else "kernels/sim_max"
    assert spans == {"kernels/context_tower": -(-N_VID // CONTEXT_BSZ),
                     "kernels/query_tower": blocks,
                     scorer: branches * blocks}

    rows.clear()
    narrow = evaluate.score_matrices(model, videos, queries, CONTEXT_BSZ,
                                     QUERY_BSZ, CPU, score_quant=score_quant)
    assert len(rows) == -(-N_Q // QUERY_BSZ)
    assert got == evaluate._metrics_from_score_matrices(
        *narrow, evaluate._gt_on_device(queries, videos, CPU), (0.7, 0.3))

    wide = evaluate.score_matrices(model, videos, queries, CONTEXT_BSZ,
                                   BLOCK, CPU, score_quant=score_quant)
    assert (wide[1] is None) == (narrow[1] is None) == (not double_branch)
    for w, n in zip(wide, narrow):
        if w is not None:
            assert w.shape[0] == N_Q and torch.equal(w, n)
