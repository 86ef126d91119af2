"""eval.h2d_host_ms: per traced eval call, the host ms inside the
program's `eval/h2d` spans (their union): the eval engine staging,
padding and copying its inputs to the card."""

from benchmark import trace


def read(run):
    t = run.trace
    if t is None:
        return None
    spans = t.range_spans("eval/h2d")
    if not spans:
        return None
    return trace.length(trace.merged(spans)) * 1e-3 / run.extra["traced_calls"]
