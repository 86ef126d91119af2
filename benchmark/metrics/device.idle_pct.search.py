"""device.idle_pct.search: the share of the traced searches' window in
which no kernel runs (copies and the dispatcher's waits for arrivals
count as idle), in %."""

from benchmark import trace


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    return 100.0 * trace.idle_share(run.trace)
