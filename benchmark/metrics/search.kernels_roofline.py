"""search.kernels_roofline: the least time the card could take for the
traced searches' work (cost/model_ops.search_work: each call's real queries
through both query towers and scored against every frame, the index
read once a call; the larger of operations over 495 TFLOP/s and bytes
over 3.35 TB/s, summed over the calls) over the device time of all
kernels in the traced window (the union of their spans), in %."""

from benchmark import trace


def read(run):
    t = run.trace
    if t is None or not t.kernels or not run.work.get("traced_least_s"):
        return None
    busy_s = trace.length(t.kernel_spans()) * 1e-6
    return 100.0 * run.work["traced_least_s"] / busy_s
