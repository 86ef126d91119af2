"""eval.h2d_exposed_ms: per eval call, the ms in which a host-to-device
copy runs and no kernel runs (the traced calls' profiler spans)."""

from benchmark import trace


def read(run):
    t = run.trace
    if t is None or not t.copies:
        return None
    h2d = t.h2d_spans()
    exposed = trace.length(h2d) - trace.length(
        trace.intersect(h2d, t.kernel_spans()))
    return exposed * 1e-3 / run.extra["traced_calls"]
