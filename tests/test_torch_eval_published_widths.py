"""The port's retrieval eval at the benchmark configurations' published
widths, held against the benchmark's plain reference.

`evaluate.run_retrieval_eval` (the resident engine on the CPU, so every
kernel wrapper runs its plain version) on seeded weights and inputs,
against `benchmark/reference/eval_ref.reference_eval` (plain PyTorch,
importing nothing of the port). Every width comes from the configuration
file: TVR's test eval (i3d_resnet frames 3,072 wide, RoBERTa tokens 768)
and ActivityNet's (1,024 and 1,024), hidden 384 x 2 branches, 128 frames
and 30 tokens. Only the counts are small: 7 videos in context batches of
3, so the last batch is padded, and 23 queries at eval_query_bsz 5, which
the resident engine encodes and scores in one trimmed block. Imports no
JAX.
"""

import json
from pathlib import Path

import pytest
import torch

from benchmark import inputs
from benchmark.loops import common
from benchmark.loops.eval import Capture
from benchmark.reference import eval_ref
from dldkd_tpu_torch import evaluate, float32_matmul_precision
from dldkd_tpu_torch.config import EvalConfig
from dldkd_tpu_torch.data.ingest import PackedQueries, PackedVideos

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SEED = 2**31 + 22
SMALL = dict(n_videos=7, n_queries=23, eval_context_bsz=3, eval_query_bsz=5)

# Max error over the reference's largest magnitude (frames, pooled
# queries) and max absolute error (cosine scores in [-1, 1]). Both sides
# compute in float32 on the CPU with the same operations in other orders
# and groupings (the port's fused LayerNorm statistics, its head-split
# attention, blocked products), so they differ by roundings that grow
# with the input depth: readings at these sizes are 1.5e-7 - 8.5e-7.
# The limits leave 20 times that or more, and lie ten times or more below
# what the reference reads with its weights and inputs rounded to TF32's
# 10-bit mantissa at these widths (scores 1.0e-4, queries 4.2e-4, frames
# 6.9e-4).
FRAMES_REL = 2e-5
QUERIES_REL = 2e-5
SCORES_ABS = 1e-5


def _config(name: str) -> dict:
    with open(ROOT / "benchmark" / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    return dict(cfg, **SMALL)


@pytest.fixture(scope="module", params=["tvr_test", "activitynet"])
def run(request):
    """(cfg, the port's kept outputs, the reference's outputs, gt)."""
    cfg = _config(request.param)
    with open(ROOT / "benchmark" / "mixes" / "eval.json") as f:
        mix = json.load(f)
    data = inputs.eval_inputs(cfg, mix, SEED, CPU)
    weights = inputs.weights(cfg, SEED, CPU)
    model = common.port_model(cfg, weights, CPU).eval()
    nv, nq = cfg["n_videos"], cfg["n_queries"]
    videos = PackedVideos(data["vfeats"], data["vmask"], inputs.ids("v", nv))
    queries = PackedQueries(data["qfeats"], data["qmask"],
                            [f"v{g}#{i}" for i, g in enumerate(data["gt"])],
                            [f"v{g}" for g in data["gt"]])
    eval_cfg = EvalConfig(eval_query_bsz=cfg["eval_query_bsz"],
                          eval_context_bsz=cfg["eval_context_bsz"],
                          score_quant=cfg["score_quant"],
                          corpus_stream_bsz=cfg["corpus_stream_bsz"])
    capture = Capture(evaluate)
    try:
        capture.armed = True
        with float32_matmul_precision(cfg["matmul_precision"]):
            metrics = evaluate.run_retrieval_eval(model, videos, queries,
                                                  eval_cfg, device=CPU)
    finally:
        capture.restore()
    prog = capture.program_outputs(metrics)
    ref = eval_ref.reference_eval(weights, cfg, data, CPU,
                                  cfg["eval_context_bsz"])
    return cfg, prog, ref, data


def test_widths_are_the_published_ones():
    assert (_config("tvr_test")["visual_input_size"],
            _config("tvr_test")["query_input_size"]) == (3072, 768)
    assert (_config("activitynet")["visual_input_size"],
            _config("activitynet")["query_input_size"]) == (1024, 1024)


def test_engine_ran_resident_with_padded_batches(run):
    cfg, prog, _, _ = run
    n_pad = -(-cfg["n_videos"] // cfg["eval_context_bsz"]) \
        * cfg["eval_context_bsz"]
    assert n_pad > cfg["n_videos"]
    assert cfg["n_queries"] % cfg["eval_query_bsz"]
    for frames in prog["frames"].values():
        assert frames.shape == (n_pad, cfg["max_ctx_l"],
                                cfg["inheritance_hidden"])
    for pooled in prog["queries"].values():
        assert pooled.shape == (cfg["n_queries"], cfg["inheritance_hidden"])


def test_frames_queries_and_scores_within_tolerance(run):
    _, prog, ref, data = run
    checks = eval_ref.compare_eval(prog, ref, data["gt"], data["vmask"],
                                   SCORES_ABS)
    assert checks["frames_rel_err"] <= FRAMES_REL, checks
    assert checks["queries_rel_err"] <= QUERIES_REL, checks
    assert checks["scores_abs_err"] <= SCORES_ABS, checks


def test_ranks_and_metrics_exact(run):
    _, prog, ref, _ = run
    keys = {"inheritance": "inher", "exploration": "explore",
            "fused": "fused"}
    assert set(prog["metrics"]) == {keys[k] for k in ref["ranks"]}
    for rkey, ranks in ref["ranks"].items():
        mine = prog["ranks"][keys[rkey]].long()[:len(ranks)]
        assert torch.equal(mine, ranks.long()), rkey
        want = eval_ref.metrics_from_ranks(ranks.numpy())
        got = prog["metrics"][keys[rkey]]
        assert {k: got[k] for k in want} == want, rkey
