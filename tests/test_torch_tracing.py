"""The port's spans and counters (`dldkd_tpu_torch/utils/tracing.py`) and
the benchmark's readers of them.

A tiny eval on the CPU (the kernels' plain versions) under torch.profiler:
the eval's layer spans nest under eval/run, the eval/h2d and kernels/*
spans number what the engine's batches give, and eval.h2d_bytes is the
bytes of the staged batches (context batches padded, query blocks
trimmed). With no profiler a span is one shared no-op
and nothing is counted. The readers under benchmark/metrics/ read a
hand-built trace and hand-made counts. Imports no JAX.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import trace
from benchmark.harness import Result, metric_reader
from dldkd_tpu_torch import evaluate
from dldkd_tpu_torch.config import EvalConfig, ModelConfig
from dldkd_tpu_torch.data.ingest import PackedQueries, PackedVideos
from dldkd_tpu_torch.models import DLDKD
from dldkd_tpu_torch.utils import tracing

from tests.test_torch_cuda import _TRAIN_CFG, _step_on, _train_batch

L, DV, DQ, LQ = 8, 16, 12, 4
CONTEXT_BSZ, QUERY_BSZ, STREAM_BLOCK = 16, 10, 16
# the resident engine's query block (run_retrieval_eval's floor under
# QUERY_BSZ); N_Q spans two blocks and a trimmed third
RESIDENT_BLOCK = max(QUERY_BSZ, evaluate.RESIDENT_QUERY_BSZ)
N_VID, N_Q = 37, 2 * RESIDENT_BLOCK + 23
CPU = torch.device("cpu")
EVAL_SPANS = ("eval/pack_weights", "eval/corpus", "eval/score", "eval/rank")


def _data():
    rng = np.random.RandomState(0)
    vmask = (np.arange(L)[None] < rng.randint(1, L + 1, N_VID)[:, None]
             ).astype(np.float32)
    ids = [f"v{i}" for i in range(N_VID)]
    gt = [ids[rng.randint(N_VID)] for _ in range(N_Q)]
    return (PackedVideos(feats=rng.randn(N_VID, L, DV).astype(np.float32),
                         mask=vmask, ids=ids),
            PackedQueries(feats=rng.randn(N_Q, LQ, DQ).astype(np.float32),
                          mask=np.ones((N_Q, LQ), np.float32),
                          cap_ids=[f"{v}#enc#{i}" for i, v in enumerate(gt)],
                          video_ids=gt))


def _model(double_branch: bool):
    cfg = ModelConfig(visual_input_size=DV, query_input_size=DQ,
                      inheritance_hidden=8, exploration_hidden=8,
                      max_ctx_l=L, max_desc_l=LQ, n_heads=2,
                      double_branch=double_branch, label_style="soft")
    return DLDKD(cfg).init_weights(torch.Generator().manual_seed(0)).eval()


def _ceil(n, k):
    return -(-n // k)


def _expected(engine: str, branches: int):
    """(span counts, eval.h2d_bytes) of one eval at this file's sizes, from
    the engine's batches: f32 frames, masks and query tokens, int32
    ground truth."""
    f32 = 4
    if engine == "resident":
        nc, nq = _ceil(N_VID, CONTEXT_BSZ), _ceil(N_Q, RESIDENT_BLOCK)
        # a context batch's frames and mask (padded), a query block's
        # tokens and mask (the last trimmed): one hand-over each, one
        # query-tower launch and one scorer launch per branch a block;
        # then the ground truth's hand-over
        spans = {"eval/h2d": nc + nq + 1,
                 "kernels/context_tower": nc, "kernels/query_tower": nq,
                 "kernels/sim_max": branches * nq}
        nbytes = nc * CONTEXT_BSZ * L * (DV + 1) * f32
    else:   # streaming: the queries in blocks of max(bsz, 64), no padding
        nb, nq = _ceil(N_VID, STREAM_BLOCK), _ceil(N_Q, max(QUERY_BSZ, 64))
        spans = {"eval/h2d": nq + nb + 1, "kernels/context_tower": nb,
                 "kernels/query_tower": nq, "kernels/sim_max": branches * nb}
        nbytes = N_VID * L * (DV + 1) * f32
    return spans, nbytes + N_Q * LQ * (DQ + 1) * f32 + N_Q * 4


def _ranges(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"]


def _eval(model, engine):
    videos, queries = _data()
    eval_cfg = EvalConfig(eval_query_bsz=QUERY_BSZ,
                          eval_context_bsz=CONTEXT_BSZ,
                          corpus_stream_bsz=(-1 if engine == "resident"
                                             else STREAM_BLOCK))
    with torch.no_grad():
        return evaluate.run_retrieval_eval(model, videos, queries, eval_cfg,
                                           device=CPU)


@pytest.mark.parametrize("engine,double_branch", [
    ("resident", True), ("resident", False), ("streaming", True)])
def test_eval_spans_and_bytes_under_profile(tmp_path, engine,
                                            double_branch):
    model = _model(double_branch)
    prof = tracing.start_profile(CPU)
    _eval(model, engine)
    path = tracing.stop_profile(prof, str(tmp_path))
    assert path == os.path.join(str(tmp_path), "trace.json")
    ranges = _ranges(path)
    names = [n for _, _, n in ranges]

    run, = [(a, b) for a, b, n in ranges if n == "eval/run"]
    layers = EVAL_SPANS if engine == "resident" else (
        "eval/pack_weights", "eval/corpus", "eval/rank")
    for layer in layers:
        (a, b), = [(a, b) for a, b, n in ranges if n == layer]
        assert run[0] <= a and b <= run[1], layer
    for a, b, n in ranges:
        if n.startswith(("eval/h2d", "kernels/")):
            assert run[0] <= a and b <= run[1], n

    spans, nbytes = _expected(engine, 2 if double_branch else 1)
    got = {k: names.count(k) for k in spans}
    assert got == spans
    assert sum(n.startswith("kernels/") for n in names) == sum(
        v for k, v in spans.items() if k.startswith("kernels/"))
    # no pinned slot on the CPU: eval.h2d_pinned_bytes is never counted
    assert tracing.counts() == {"eval.h2d_bytes": nbytes}
    with open(tmp_path / "counts.json") as f:
        assert json.load(f) == {"eval.h2d_bytes": nbytes}


def test_no_profile_no_spans_no_counts(tmp_path):
    tracing.stop_profile(tracing.start_profile(CPU), str(tmp_path))
    assert tracing.counts() == {}        # a profile starts from zero
    assert not tracing.recording()
    noop = tracing.span("eval/run")
    assert noop is tracing.span("kernels/sim_max")
    assert not isinstance(noop, torch.profiler.record_function)
    _eval(_model(True), "resident")
    tracing.count("eval.h2d_bytes", 5)
    assert tracing.counts() == {}


def test_train_step_ranges_under_profile(tmp_path):
    cfg = ModelConfig(**_TRAIN_CFG)
    sd = DLDKD(cfg).init_weights(torch.Generator().manual_seed(3)
                                 ).state_dict()
    prof = tracing.start_profile(CPU)
    _step_on(CPU, sd, _train_batch(np.random.RandomState(4)), cfg)
    names = [n for _, _, n in _ranges(tracing.stop_profile(prof,
                                                           str(tmp_path)))]
    for part in ("train_step/forward_losses", "train_step/backward",
                 "train_step/optimizer"):
        assert names.count(part) == 1, part


# ------------------------------------------------------------ the readers

# a window of 1,000 us over two calls: three kernels, eval/run around both
# calls, three eval/h2d spans (the last under a kernel), four kernel spans
KERNELS = [(100.0, 200.0), (400.0, 500.0), (900.0, 950.0)]
RUN = (50.0, 960.0)
H2D = [(60.0, 90.0), (250.0, 300.0), (450.0, 480.0)]
CALLS = 2


def _trace(program_spans: bool = True) -> trace.Trace:
    ranges = [(40.0, 970.0, "bench/eval_call")]
    if program_spans:
        ranges += [RUN + ("eval/run",)] + [h + ("eval/h2d",) for h in H2D]
        ranges += [(a - 5, a - 1, "kernels/sim_max") for a, _ in KERNELS]
        ranges += [(80.0, 95.0, "kernels/query_tower")]
    return trace.Trace(window=(0.0, 1000.0),
                       kernels=[k + ("sim_max_mma_kernel",) for k in KERNELS],
                       copies=[(250.0, 300.0, "Memcpy HtoD")],
                       ranges=ranges)


def _result(t):
    return Result(attempted=1, failed=0, metrics={}, checks={},
                  window_s=1.0, units=1, memory_peak_bytes=0,
                  extra={"traced_calls": CALLS}, trace=t)


@pytest.fixture
def counted_bytes():
    prof = tracing.start_profile(CPU)
    tracing.count("eval.h2d_bytes", 9_000_000)
    prof.stop()
    yield 9_000_000


# idle (no kernel): (0,100) (200,400) (500,900) (950,1000), 750 us; inside
# eval/run and outside eval/h2d: (50,60) (90,100) (200,250) (300,400)
# (500,900) (950,960), 580 us; eval/h2d's union 110 us
@pytest.mark.parametrize("name,want", [
    ("eval.h2d_host_ms", 0.110 / CALLS),
    ("eval.h2d_mb", 9.0 / CALLS),
    ("eval.kernel_launches", 4 / CALLS),
    ("eval.idle_non_copy_ms", 0.580 / CALLS)])
def test_reader_values(counted_bytes, name, want):
    read = metric_reader(name)
    assert read(_result(_trace())) == pytest.approx(want, rel=1e-12)
    assert read(_result(None)) is None


@pytest.mark.parametrize("name", ["eval.h2d_host_ms", "eval.kernel_launches",
                                  "eval.idle_non_copy_ms"])
def test_span_readers_silent_without_program_spans(name):
    assert metric_reader(name)(_result(_trace(program_spans=False))) is None


@pytest.mark.parametrize("pinned,want", [
    (9_000_000, 100.0), (8_100_000, 90.0), (None, None)],
    ids=["all", "most", "parent_program"])
def test_h2d_pinned_pct_reader(pinned, want):
    """eval.h2d_pinned_pct: the pinned counter over eval.h2d_bytes, x 100;
    nothing from a program that has no pinned counter, nor untraced."""
    prof = tracing.start_profile(CPU)
    tracing.count("eval.h2d_bytes", 9_000_000)
    if pinned is not None:
        tracing.count("eval.h2d_pinned_bytes", pinned)
    prof.stop()
    read = metric_reader("eval.h2d_pinned_pct")
    got = read(_result(_trace()))
    assert got == (None if want is None else pytest.approx(want, rel=1e-12))
    assert read(_result(None)) is None


def test_h2d_mb_silent_without_count(tmp_path):
    tracing.stop_profile(tracing.start_profile(CPU), str(tmp_path))
    assert metric_reader("eval.h2d_mb")(_result(_trace())) is None


def test_idle_splits_into_h2d_non_copy_and_outside_run():
    t = _trace()
    idle = trace.gaps(t.kernel_spans(), t.window)
    h2d_idle = trace.length(trace.intersect(idle, trace.merged(H2D)))
    outside = trace.length(trace.intersect(idle, trace.gaps([RUN], t.window)))
    non_copy = metric_reader("eval.idle_non_copy_ms")(_result(t)) \
        * CALLS * 1e3
    assert h2d_idle == 80.0 and outside == 90.0
    assert h2d_idle + non_copy + outside == pytest.approx(
        trace.idle_share(t) * (t.window[1] - t.window[0]), rel=1e-12)


def test_one_record_function_in_the_port():
    """Every span of the port goes through the gate: the only
    record_function call outside tools/ is tracing.span's."""
    root = Path(tracing.__file__).resolve().parents[1]
    found = [p for p in root.rglob("*.py")
             if "tools" not in p.relative_to(root).parts
             and "record_function(" in p.read_text()]
    assert found == [Path(tracing.__file__).resolve()]
