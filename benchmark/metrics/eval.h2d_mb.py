"""eval.h2d_mb: per traced eval call, the MB (1e6 bytes) the eval engine
hands to the card, padded rows included: the program's `eval.h2d_bytes`
counter, which counts only while a profiler records, so its total is the
traced calls'. Read in the run's own process, after the loop."""


def read(run):
    if run.trace is None:
        return None
    try:
        from dldkd_tpu_torch.utils import tracing
    except ImportError:
        return None
    total = tracing.counts().get("eval.h2d_bytes")
    if not total:
        return None
    return total / run.extra["traced_calls"] / 1e6
