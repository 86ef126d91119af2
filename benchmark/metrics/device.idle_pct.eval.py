"""device.idle_pct.eval: the share of the traced eval calls' window in
which no kernel runs (copies count as idle), in %."""

from benchmark import trace


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    return 100.0 * trace.idle_share(run.trace)
