"""search.h2d_host_ms: per traced search call, the host ms inside the
program's `serve/h2d` spans (their union): serving staging each query
batch (a slot's wait, its fill, the queued copy and the padding zeroed
on the card). A program without the spans reads nothing."""

from benchmark import trace


def read(run):
    t = run.trace
    if t is None or not run.extra.get("traced_calls"):
        return None
    spans = t.range_spans("serve/h2d")
    if not spans:
        return None
    return trace.length(trace.merged(spans)) * 1e-3 / run.extra["traced_calls"]
