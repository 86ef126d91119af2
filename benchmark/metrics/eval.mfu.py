"""eval.mfu: an eval's operations (cost/model_ops.eval_work) times the
calls of the window, over the window's host seconds times 495 TFLOP/s,
in %."""

from benchmark.cost import model_ops


def read(run):
    if run.units == 0:
        return None
    return 100.0 * run.work["flops"] * run.units / (
        run.window_s * model_ops.PEAK_FLOPS)
