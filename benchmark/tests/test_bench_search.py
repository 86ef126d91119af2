"""The cell activitynet.search: open-loop queries into Retriever.search.

On the CPU at a tiny size (the kernels' plain versions): a whole run is
correct and prints the cell's end-to-end metrics; the rate is the
answered queries over the window; latency runs from each query's due
time (a dispatcher on a virtual clock, and a planted slow search); the
planted fault fails `correct`; the arrivals, the pool's rows, the
comparison and the readers on their own. On the card, at ActivityNet's
widths with a smaller corpus and pool, the control (the reference in
TF32) fails the cell's limits and the program passes them."""

import threading
import time

import numpy as np
import pytest
import torch

from benchmark import control, faults, harness, sweep, trace
from benchmark import run as bench_run
from benchmark.cost import model_ops
from benchmark.loops import search
from benchmark.reference import search_ref
from benchmark.tests.tiny import tiny_cell

CPU = torch.device("cpu")
SEED = 2**31 + 4917
NAME = "activitynet.search"
E2E = {"search_p95_ms", "search_qps", "setup_s"}
READERS = ("search.call_ms", "search.kernel_launches",
           "search.kernels_roofline", "search.mfu", "device.idle_pct.search")


def tiny(rate=2000.0):
    c = tiny_cell(NAME)
    return harness.Cell(c.name, c.chips, c.config, dict(c.mix, rate_qps=rate),
                        c.params, c.end_to_end, c.per_layer)


def run_tiny(seconds=0.3, traced=False, cell=None):
    return bench_run.run(NAME, SEED, seconds, traced, CPU,
                         time.perf_counter(), cell=cell or tiny())


def test_cell_entries():
    cell = harness.load_cell(NAME)
    assert cell.mix["loop"] == "search" and cell.chips == 1
    assert cell.config["n_videos"] == 4917
    assert {m["name"] for m in cell.end_to_end} == E2E
    assert {m["name"] for m in cell.per_layer} == set(READERS)
    assert set(cell.params["limits"]) == {"scores_abs_err",
                                          "ids_out_of_band", "order_breaks"}


def test_tiny_run_is_correct():
    code, line = run_tiny()
    assert code == 0
    assert line["correct"] is True, line["checks"]
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == E2E
    assert line["attempted"] == round(2000.0 * 0.3) and line["failed"] == 0
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


def test_rate_is_answered_queries_over_the_window():
    r = search.run(tiny(), SEED, 0.2, False, CPU, time.perf_counter())
    assert r.failed == 0
    assert r.metrics["search_qps"] == pytest.approx(
        (r.attempted - r.failed) / r.window_s)


def test_latency_runs_from_due_times_on_a_virtual_clock():
    now = [0.0]

    def clock():
        return now[0]

    def sleep(s):
        now[0] += s

    def slow(f, m):
        now[0] += 0.05
        return np.zeros((len(f), 1)), np.zeros((len(f), 1), np.int64)

    due = np.array([0.0, 0.001, 0.002, 0.1])
    feats = masks = np.zeros((3, 2))
    calls = search.dispatch(slow, feats, masks, due, bsz=2, clock=clock,
                            sleep=sleep)
    assert [(c.start, c.stop) for c in calls] == [(0, 1), (1, 3), (3, 4)]
    np.testing.assert_allclose(search.latencies(calls, due),
                               [0.05, 0.099, 0.098, 0.05])
    stats = search.window_stats(calls, due, 0.0, 0.2, 2)
    assert stats["search_qps"] == pytest.approx(4 / 0.15)
    assert stats["full_batches"] == 1
    # a queue that grows: one query a call, each call 50 ms
    calls = search.dispatch(slow, feats, masks, due, bsz=1, clock=clock,
                            sleep=sleep)
    assert len(calls) == 4


def test_a_planted_slow_search_shows_in_the_p95(monkeypatch):
    from dldkd_tpu_torch import serving

    plain = serving.Retriever.search
    delay = 0.04

    def slow(self, *args, **kwargs):
        time.sleep(delay)
        return plain(self, *args, **kwargs)

    monkeypatch.setattr(serving.Retriever, "search", slow)
    r = search.run(tiny(rate=200.0), SEED, 0.3, False, CPU,
                   time.perf_counter())
    # every query waits for at least its own call, most for more
    assert r.metrics["search_p95_ms"] >= delay * 1e3
    assert r.extra["call_ms"] >= delay * 1e3


def test_altered_scores_are_not_correct():
    undo = faults.FAULTS["alter_search_scores"]()
    try:
        code, line = run_tiny()
    finally:
        undo()
    assert code == 0
    assert line["correct"] is False, line["checks"]


def test_run_leaves_no_thread():
    before = threading.active_count()
    code, _ = run_tiny()
    assert code == 0
    assert threading.active_count() == before


def test_traced_run_without_cuda_events_fails():
    code, line = run_tiny(traced=True)
    assert code == 4 and line is None


def test_arrivals_are_the_same_gaps_in_the_seed_order():
    a = search.arrival_offsets(1000.0, 2.0, SEED)
    b = search.arrival_offsets(1000.0, 2.0, SEED)
    c = search.arrival_offsets(1000.0, 2.0, SEED + 1)
    assert len(a) == 2000 and a[0] == 0.0 and a[-1] < 2.0
    assert np.all(np.diff(a) > 0)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    gaps = [np.sort(np.diff(np.append(x, 2.0))) for x in (a, c)]
    np.testing.assert_allclose(gaps[0], gaps[1], rtol=1e-9)


def test_pool_rows_are_a_view_unless_the_pool_wraps():
    feats = np.arange(10.0).reshape(5, 2)
    masks = np.ones((5, 2))
    f, _ = search.pool_rows(feats, masks, 6, 9)
    assert np.shares_memory(f, feats)
    np.testing.assert_array_equal(f, feats[1:4])
    f, _ = search.pool_rows(feats, masks, 3, 7)
    assert not np.shares_memory(f, feats)
    np.testing.assert_array_equal(f, feats[[3, 4, 0, 1]])


def _reference_case():
    g = torch.Generator().manual_seed(3)
    ref = torch.rand((4, 30), generator=g)
    vals, ids = search_ref.top_k(ref, 5)
    return ref, vals.numpy().copy(), ids.numpy().copy()


def test_comparison_passes_the_reference_itself():
    ref, vals, ids = _reference_case()
    got = search_ref.compare_search(vals, ids, ref, 5, 1e-5)
    assert got == {"scores_abs_err": 0.0, "ids_out_of_band": 0.0,
                   "order_breaks": 0.0}


@pytest.mark.parametrize("plant,caught", [
    ("score", "scores_abs_err"),
    ("far_id", "ids_out_of_band"),
    ("swap", "order_breaks"),
    ("twice", "order_breaks"),
    ("outside", "order_breaks"),
    ("tie_order", "order_breaks"),
    ("short", "order_breaks"),
    ("missing_row", "order_breaks"),
])
def test_comparison_catches(plant, caught):
    ref, vals, ids = _reference_case()
    if plant == "score":
        vals[1, 2] += 1e-3
    elif plant == "far_id":
        worst = int(torch.argmin(ref[0]))
        ids[0, 4], vals[0, 4] = worst, float(ref[0, worst])
    elif plant == "swap":
        ids[2, [0, 1]] = ids[2, [1, 0]]
        vals[2, [0, 1]] = vals[2, [1, 0]]
    elif plant == "twice":
        ids[3, 1] = ids[3, 0]
    elif plant == "outside":
        ids[3, 4] = 30
    elif plant == "short":
        # the best k - 1 of every row: right as far as it goes
        vals, ids = vals[:, :-1], ids[:, :-1]
    elif plant == "missing_row":
        vals, ids = vals[:-1], ids[:-1]
    else:
        ref[1, :] = 0.5
        ids[1] = [4, 3, 2, 1, 0]
        vals[1] = 0.5
    got = search_ref.compare_search(vals, ids, ref, 5, 1e-5)
    limits = {"scores_abs_err": 1e-5, "ids_out_of_band": 0,
              "order_breaks": 0}
    assert got[caught] > limits[caught], got


def test_work_counts_real_queries_and_one_index_read():
    cfg = harness.load_cell(NAME).config
    index = 4 * (2 * 4917 * 128 * 384 + 4917 * 128)
    none = model_ops.search_work(cfg, 0, 10)
    assert none["flops"] == 0 and none["bytes"] == index
    one, two = (model_ops.search_work(cfg, n, 10) for n in (1, 2))
    assert two["flops"] == 2 * one["flops"]
    assert two["bytes"] - one["bytes"] == one["bytes"] - index
    # the index read bounds a call at serving's batch
    assert search.least_seconds(cfg, 256, 10) == pytest.approx(
        model_ops.search_work(cfg, 256, 10)["bytes"] / 3.35e12)


@pytest.fixture(scope="module")
def untraced():
    return search.run(tiny(), SEED, 0.2, False, CPU, time.perf_counter())


@pytest.mark.parametrize("name", READERS)
def test_readers_on_an_untraced_run(untraced, name):
    v = harness.metric_reader(name)(untraced)
    if name in ("search.call_ms", "search.mfu"):
        assert v is not None and v > 0
    else:
        assert v is None


def test_readers_on_a_hand_built_trace(untraced):
    t = trace.Trace(window=(0.0, 1000.0),
                    kernels=[(100.0, 300.0, "k"), (200.0, 400.0, "k"),
                             (600.0, 700.0, "k")],
                    ranges=[(90.0, 310.0, "kernels/query_tower"),
                            (310.0, 320.0, "kernels/sim_max"),
                            (330.0, 340.0, "kernels/sim_max"),
                            (50.0, 800.0, "bench/search_call")])
    r = harness.Result(attempted=4, failed=0, metrics={}, checks={},
                       window_s=1.0, units=2, memory_peak_bytes=0,
                       extra={"traced_calls": 2, "call_ms": 5.0}, trace=t,
                       work={"flops": 99e12, "call_s": 0.5,
                             "traced_least_s": 2e-4})
    read = {n: harness.metric_reader(n)(r) for n in READERS}
    assert read["search.kernel_launches"] == 1.5
    # kernels busy 400 us of the 1,000-us window
    assert read["search.kernels_roofline"] == pytest.approx(50.0)
    assert read["device.idle_pct.search"] == pytest.approx(60.0)
    # 99 TFLOP in 0.5 s of calls: 198 TFLOP/s of 495, whatever the window
    assert read["search.mfu"] == pytest.approx(40.0)


def test_control_reads_the_search_cell():
    assert control.CONTROLS["search"] is control.search_control
    assert control.main(["--workload", NAME, "--fault",
                         "alter_search_scores"]) == 0
    got = control.search_control(tiny(), SEED, CPU)
    assert set(got) == {"scores_abs_err", "ids_out_of_band", "order_breaks"}
    assert got["order_breaks"] == 0


@pytest.mark.parametrize("p95,last_third,by_end,sustained", [
    (25.0, 25.0, 1.0, True),
    (35.0, 25.0, 1.0, False),    # a queue built and drained: p95 > 3 calls
    (25.0, 40.0, 1.0, False),    # the queue grows through the window
    (25.0, 25.0, 0.98, False),   # answers lag the offered load
])
def test_sweep_sustains_a_rate_only_without_a_queue(p95, last_third, by_end,
                                                    sustained):
    stats = {"offered": 1000, "answered_by_end": int(1000 * by_end),
             "p95_first_third_ms": 25.0, "p95_last_third_ms": last_third,
             "search_p95_ms": p95, "call_ms": 10.0}
    assert sweep.sustained(stats) is sustained


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [41, 2**31 + 97])
def test_control_fails_and_program_passes(seed):
    device = card()
    c = harness.load_cell(NAME)
    cell = harness.Cell(c.name, c.chips,
                        dict(c.config, n_videos=600, n_queries=2000), c.mix,
                        c.params, c.end_to_end, c.per_layer)
    limits = cell.params["limits"]
    low = control.search_control(cell, seed, device)
    assert not harness.judge(low, limits), low
    r = search.run(cell, seed, 1.0, False, device, time.perf_counter())
    assert harness.judge(r.checks, limits), r.checks
