"""The benchmark's arithmetic on hand-made numbers: spans, idle share,
exposed copies, the per-layer readers, the work counts and the rates."""

import pytest

from benchmark import harness, trace
from benchmark.cost import model_ops


def test_union_of_spans():
    spans = [(5, 7), (0, 2), (1, 3), (6, 9), (10, 11)]
    assert trace.merged(spans) == [(0, 3), (5, 9), (10, 11)]
    assert trace.length(trace.merged(spans)) == 8


def test_intersect_and_gaps():
    a = [(0, 4), (6, 10)]
    b = [(2, 7), (9, 12)]
    assert trace.intersect(a, b) == [(2, 4), (6, 7), (9, 10)]
    assert trace.gaps(a, (-1, 12)) == [(-1, 0), (4, 6), (10, 12)]
    assert trace.gaps([], (0, 5)) == [(0, 5)]


def hand_trace():
    # window 0-100 us; kernels cover 10-30 and 50-60; an H2D copy 20-52
    return trace.Trace(
        window=(0.0, 100.0),
        kernels=[(10.0, 30.0, "k1"), (15.0, 25.0, "k2"), (50.0, 60.0, "k1")],
        copies=[(20.0, 52.0, "Memcpy HtoD (Pageable -> Device)"),
                (70.0, 75.0, "Memcpy DtoH (Device -> Pageable)")],
        ranges=[(0.0, 40.0, "train_step/optimizer"),
                (40.0, 100.0, "train_step/optimizer")])


def result(**kw):
    base = dict(attempted=4, failed=0, metrics={}, checks={}, window_s=2.0,
                units=4, memory_peak_bytes=0,
                extra={"traced_calls": 2, "traced_steps": 2,
                       "input_wait_s": 0.1},
                trace=hand_trace(), work={"flops": 495e12 * 1e-6,
                                          "bytes": 0.0})
    base.update(kw)
    return harness.Result(**base)


def test_idle_share_counts_copies_idle():
    assert trace.idle_share(hand_trace()) == pytest.approx(0.7)


def test_busy_counts_every_device_operation():
    # kernels 10-30, 50-60; copies 20-52, 70-75
    assert trace.length(hand_trace().busy_spans()) == 55


@pytest.mark.parametrize("name,value", [
    ("eval.h2d_exposed_ms", (50 - 30) * 1e-3 / 2),
    ("device.idle_pct.eval", 70.0),
    ("device.idle_pct.train", 70.0),
    ("train.kernels_per_step", 1.5),
    ("train.optimizer_host_ms", 50e-3),
    ("train.input_wait_ms", 25.0),
    # 1 us of work at peak per unit, 4 units in 2 s
    ("eval.mfu", 100.0 * 4e-6 / 2),
    ("train.mfu", 100.0 * 4e-6 / 2),
    # least 1 us per call, 2 traced calls, 30 us of kernels
    ("eval.kernels_roofline", 100.0 * 2e-6 / 30e-6),
])
def test_per_layer_readers(name, value):
    assert harness.metric_reader(name)(result()) == pytest.approx(value)


@pytest.mark.parametrize("name", [
    "eval.h2d_exposed_ms", "device.idle_pct.eval", "train.kernels_per_step",
    "eval.kernels_roofline", "train.optimizer_host_ms"])
def test_readers_return_nothing_without_a_trace(name):
    assert harness.metric_reader(name)(result(trace=None)) is None


def test_breakdown_names_gaps_by_host_activity():
    t = hand_trace()
    b = trace.breakdown(t)
    assert b["device_ops"][0][0] == "Memcpy HtoD (Pageable -> Device)"
    assert dict(b["device_ops"])["k1"] == pytest.approx(30e-6)
    idle = dict(b["idle_gaps"])
    assert sum(idle.values()) == pytest.approx(70e-6)
    assert set(idle) == {"train_step/optimizer"}


def small_cfg(**kw):
    cfg = dict(visual_input_size=6, query_input_size=5, inheritance_hidden=4,
               exploration_hidden=4, max_ctx_l=3, max_desc_l=2,
               double_branch=True, n_videos=2, n_queries=3, bsz=2,
               captions_per_video=3, query_pad_multiple=4, teacher_size=7)
    cfg.update(kw)
    return cfg


def test_tower_counts_by_hand():
    # video: input 2*3*6*4=144; QKV+out 2*3*4*16=384; attention 2*2*9*4=144;
    # out mapping 2*3*16=96
    assert model_ops.video_tower_flops(3, 6, 4) == 144 + 384 + 144 + 96
    # query: input 2*2*5*4=80; block 2*2*64 + 4*4*4 = 256 + 64; pooling 32
    assert model_ops.query_tower_flops(2, 5, 4) == 80 + 320 + 32
    assert model_ops.score_flops(3, 2, 3, 4) == 144


def test_eval_work_by_hand():
    w = model_ops.eval_work(small_cfg())
    flops = 2 * (2 * 768 + 3 * 432 + 144)
    assert w["flops"] == flops
    # per branch: query side 10 + 24 + 8 + 8 + 88 + 4 (LayerNorm, projection,
    # positions, LayerNorm, attention block, pooling head), video side
    # 12 + 28 + 12 + 8 + 88 + 20 (the same, then the output mapping)
    n_par = 2 * (142 + 168)
    assert model_ops.n_params(small_cfg()) == n_par
    # frames and masks, tokens and masks, weights, 3 ranks a query
    assert w["bytes"] == 4 * (2 * 3 * 7 + 3 * 2 * 6 + n_par + 3 * 3)


def test_train_flops_by_hand():
    # 2 videos x 3 captions = 6, padded to 8 queries
    student = 2 * (2 * 768 + 8 * 432 + 2 * model_ops.score_flops(8, 2, 3, 4))
    teacher = 2 * model_ops.score_flops(8, 2, 3, 7)
    assert model_ops.train_step_flops(small_cfg()) == 3 * student + teacher


def test_least_seconds_takes_the_larger_bound():
    assert model_ops.least_seconds(495e12, 0.0) == 1.0
    assert model_ops.least_seconds(0.0, 6.7e12) == pytest.approx(2.0)


def test_judge_needs_every_number_under_its_limit():
    limits = {"a": 1.0, "b": 0}
    assert harness.judge({"a": 1.0, "b": 0.0}, limits)
    assert not harness.judge({"a": 1.5, "b": 0.0}, limits)
    assert not harness.judge({"a": float("nan"), "b": 0.0}, limits)
    assert not harness.judge({"a": 0.5}, limits)
