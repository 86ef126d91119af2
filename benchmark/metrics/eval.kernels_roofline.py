"""eval.kernels_roofline: the least time the card could take for an
eval's work (cost/model_ops.eval_work: the larger of its operations over
495 TFLOP/s and its bytes over 3.35 TB/s) over the device time of all
kernels of the traced eval calls (the union of their spans), in %."""

from benchmark import trace
from benchmark.cost import model_ops


def read(run):
    t = run.trace
    if t is None or not t.kernels:
        return None
    busy_s = trace.length(t.kernel_spans()) * 1e-6
    least = model_ops.least_seconds(run.work["flops"], run.work["bytes"])
    return 100.0 * least * run.extra["traced_calls"] / busy_s
