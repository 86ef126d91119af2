"""eval.corpus_idle_ms: per traced eval call, the ms in which no kernel
runs (copies count as idle, as in device.idle_pct.eval) while the host
is inside the program's `eval/corpus` spans: what the corpus phase's
fill and copies leave exposed."""

from benchmark import trace


def read(run):
    t = run.trace
    if t is None:
        return None
    inside = trace.merged(t.range_spans("eval/corpus"))
    if not inside:
        return None
    idle = trace.gaps(t.kernel_spans(), t.window)
    return trace.length(trace.intersect(idle, inside)) * 1e-3 \
        / run.extra["traced_calls"]
