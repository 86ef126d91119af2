"""search.kernel_launches: per traced search call, the calls into the
program's hand-written kernels: its `kernels/*` spans, one a call of a
kernel wrapper (a query-tower chain, a scorer launch), whatever number
of CUDA kernels the call runs."""


def read(run):
    t = run.trace
    if t is None or not run.extra.get("traced_calls"):
        return None
    n = sum(1 for _, _, name in t.ranges if name.startswith("kernels/"))
    if n == 0:
        return None
    return n / run.extra["traced_calls"]
