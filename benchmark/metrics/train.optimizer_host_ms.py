"""train.optimizer_host_ms: host ms per step inside the program's
`train_step/optimizer` range (BertAdam's per-tensor update), over the
traced steps."""


def read(run):
    t = run.trace
    if t is None:
        return None
    spans = t.range_spans("train_step/optimizer")
    if not spans:
        return None
    return sum(b - a for a, b in spans) * 1e-3 / len(spans)
