"""eval.idle_non_copy_ms: per traced eval call, the ms in which no kernel
runs (copies count as idle, as in device.idle_pct.eval), the host is
inside the program's `eval/run` span and outside every `eval/h2d` span:
the idle time that the eval's own Python, syncs and host work hold, not
its copies."""

from benchmark import trace


def read(run):
    t = run.trace
    if t is None:
        return None
    inside = trace.merged(t.range_spans("eval/run"))
    if not inside:
        return None
    idle = trace.gaps(t.kernel_spans(), t.window)
    not_h2d = trace.gaps(trace.merged(t.range_spans("eval/h2d")), t.window)
    held = trace.intersect(trace.intersect(idle, inside), not_h2d)
    return trace.length(held) * 1e-3 / run.extra["traced_calls"]
