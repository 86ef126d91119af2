"""The reader search.h2d_host_ms: on a hand-built trace, on a traced run
of a program without serving's `serve/h2d` spans, and on an untraced
run."""

import pytest

from benchmark import harness, trace

NAME = "search.h2d_host_ms"


def result(ranges, traced_calls=2, with_trace=True):
    t = trace.Trace(window=(0.0, 1000.0), kernels=[(100.0, 300.0, "k")],
                    ranges=ranges)
    return harness.Result(attempted=4, failed=0, metrics={}, checks={},
                          window_s=1.0, units=2, memory_peak_bytes=0,
                          extra={"traced_calls": traced_calls,
                                 "call_ms": 5.0},
                          trace=t if with_trace else None,
                          work={"flops": 1e9, "call_s": 0.5,
                                "traced_least_s": 2e-4})


def test_reads_the_union_of_the_spans_per_traced_call():
    # two calls: 300 us, then two overlapping spans whose union is 500 us
    r = result([(0.0, 300.0, "serve/h2d"), (400.0, 800.0, "serve/h2d"),
                (600.0, 900.0, "serve/h2d"),
                (0.0, 950.0, "bench/search_call")])
    assert harness.metric_reader(NAME)(r) == pytest.approx(0.4)


@pytest.mark.parametrize("ranges,traced_calls,with_trace", [
    ([(0.0, 900.0, "bench/search_call")], 2, True),   # no serve/h2d span
    ([(0.0, 300.0, "serve/h2d")], 0, True),           # no traced call
    ([(0.0, 300.0, "serve/h2d")], 2, False),          # an untraced run
], ids=["no_spans", "no_calls", "untraced"])
def test_reads_nothing_without_spans_or_a_trace(ranges, traced_calls,
                                                with_trace):
    r = result(ranges, traced_calls, with_trace)
    assert harness.metric_reader(NAME)(r) is None
