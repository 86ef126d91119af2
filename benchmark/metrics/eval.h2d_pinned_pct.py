"""eval.h2d_pinned_pct: the share of the bytes the eval engine hands to
the card that went through a pinned staging slot: the program's
`eval.h2d_pinned_bytes` counter over its `eval.h2d_bytes`, x 100, over
the traced calls. Both count only while a profiler records. A program
without the pinned counter reads nothing. Read in the run's own process,
after the loop."""


def read(run):
    if run.trace is None:
        return None
    try:
        from dldkd_tpu_torch.utils import tracing
    except ImportError:
        return None
    totals = tracing.counts()
    pinned, total = totals.get("eval.h2d_pinned_bytes"), totals.get(
        "eval.h2d_bytes")
    if not pinned or not total:
        return None
    return 100.0 * pinned / total
