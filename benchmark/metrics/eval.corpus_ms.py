"""eval.corpus_ms: per traced eval call, the host ms inside the program's
`eval/corpus` spans (their union): the corpus phase, from the first
context batch's fill to the last batch's video towers queued, with its
copies between."""

from benchmark import trace


def read(run):
    t = run.trace
    if t is None:
        return None
    spans = t.range_spans("eval/corpus")
    if not spans:
        return None
    return trace.length(trace.merged(spans)) * 1e-3 / run.extra["traced_calls"]
