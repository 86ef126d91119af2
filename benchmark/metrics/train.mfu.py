"""train.mfu: a step's model operations (cost/model_ops.train_step_flops)
times the steps of the window, over the window's host seconds times 495
TFLOP/s, in %."""

from benchmark.cost import model_ops


def read(run):
    if run.units == 0:
        return None
    return 100.0 * run.work["flops"] * run.units / (
        run.window_s * model_ops.PEAK_FLOPS)
