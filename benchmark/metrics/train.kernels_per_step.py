"""train.kernels_per_step: CUDA kernels launched per step over the traced
steps (the device is idle when the traced window opens and closes, so
each kernel belongs to one of them)."""


def read(run):
    t = run.trace
    if t is None or not t.kernels:
        return None
    return len(t.kernels) / run.extra["traced_steps"]
