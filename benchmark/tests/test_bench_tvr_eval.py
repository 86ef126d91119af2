"""The cell tvr.eval: the TVR test eval at its published widths.

On the CPU, the tiny-size run (`tiny.tiny_cell`) is correct and prints
the cell's end-to-end metrics, and the corpus phase's two readers read a
hand-built trace, the program's own spans in a traced CPU run, and
nothing in an untraced one. On the card, at TVR's widths with a smaller
corpus, the control (the reference in TF32) fails the cell's limits and
the program passes them."""

import time

import pytest
import torch

from benchmark import control, harness, trace
from benchmark import run as bench_run
from benchmark.tests.tiny import tiny_cell

CPU = torch.device("cpu")
SEED = 2**31 + 2179
NAME = "tvr.eval"
READERS = ("eval.corpus_ms", "eval.corpus_idle_ms")


def test_tiny_run_is_correct():
    code, line = bench_run.run(NAME, SEED, 0.3, False, CPU,
                               time.perf_counter(), cell=tiny_cell(NAME))
    assert code == 0
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"eval_qps", "setup_s"}
    assert line["failed"] == 0 and line["attempted"] >= 1


def test_cell_reports_the_eval_metrics_and_the_corpus_readers():
    cell = harness.load_cell(NAME)
    assert cell.config["visual_input_size"] == 3072
    assert cell.config["query_input_size"] == 768
    assert cell.mix["loop"] == "eval"
    names = {m["name"] for m in cell.per_layer}
    assert set(READERS) <= names and len(names) == 11
    assert set(cell.params["limits"]) == {
        "frames_rel_err", "queries_rel_err", "scores_abs_err",
        "ranks_out_of_band", "metrics_gap"}


def _tiny_result(traced: bool) -> harness.Result:
    return harness.loop("eval").run(tiny_cell(NAME), SEED, 0.1, traced,
                                    CPU, time.perf_counter())


@pytest.fixture(scope="module")
def untraced():
    return _tiny_result(False)


@pytest.mark.parametrize("name", READERS)
def test_readers_return_nothing_on_an_untraced_run(untraced, name):
    assert harness.metric_reader(name)(untraced) is None


def test_readers_read_the_programs_corpus_span_on_a_traced_run():
    # the CPU runs no CUDA kernel: the whole corpus phase is idle
    r = _tiny_result(True)
    corpus = harness.metric_reader("eval.corpus_ms")(r)
    idle = harness.metric_reader("eval.corpus_idle_ms")(r)
    assert corpus is not None and corpus > 0
    assert idle == pytest.approx(corpus)
    spans = r.trace.range_spans("eval/corpus")
    assert len(spans) == r.extra["traced_calls"]


def _hand_result():
    # two calls; corpus phases 0-40 and 100-130 us; kernels 10-20, 35-60,
    # 120-125: idle inside the corpus phases 0-10, 20-35, 100-120, 125-130
    t = trace.Trace(window=(0.0, 200.0),
                    kernels=[(10.0, 20.0, "k"), (35.0, 60.0, "k"),
                             (120.0, 125.0, "k")],
                    copies=[(5.0, 30.0, "Memcpy HtoD (Pinned -> Device)")],
                    ranges=[(0.0, 40.0, "eval/corpus"),
                            (100.0, 130.0, "eval/corpus"),
                            (0.0, 150.0, "eval/run")])
    return harness.Result(attempted=2, failed=0, metrics={}, checks={},
                          window_s=1.0, units=2, memory_peak_bytes=0,
                          extra={"traced_calls": 2}, trace=t)


@pytest.mark.parametrize("name,value", [
    ("eval.corpus_ms", (40 + 30) * 1e-3 / 2),
    ("eval.corpus_idle_ms", (10 + 15 + 20 + 5) * 1e-3 / 2),
])
def test_readers_on_a_hand_built_trace(name, value):
    assert harness.metric_reader(name)(_hand_result()) == pytest.approx(value)


@pytest.mark.parametrize("name", READERS)
def test_readers_silent_without_the_corpus_span(name):
    r = _hand_result()
    r.trace.ranges = [x for x in r.trace.ranges if x[2] != "eval/corpus"]
    assert harness.metric_reader(name)(r) is None


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [37, 2**31 + 2179])
def test_control_fails_and_program_passes_at_tvr_widths(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    device = torch.device("cuda")
    c = harness.load_cell(NAME)
    cell = harness.Cell(c.name, c.chips,
                        dict(c.config, n_videos=600, n_queries=2000), c.mix,
                        c.params, c.end_to_end, c.per_layer)
    limits = cell.params["limits"]
    low = control.eval_control(cell, seed, device)
    assert not harness.judge(low, limits), low
    r = harness.loop("eval").run(cell, seed, 1.0, False, device,
                                 time.perf_counter())
    assert harness.judge(r.checks, limits), r.checks
