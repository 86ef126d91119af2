"""device.idle_pct.train: the share of the traced steps' window in
which no kernel runs (copies count as idle), in %."""

from benchmark import trace


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    return 100.0 * trace.idle_share(run.trace)
