"""train.input_wait_ms: host ms per step of the window that the step loop
waits for its next batch from `device_prefetch` (the harness's span
around the fetch)."""


def read(run):
    if run.units == 0:
        return None
    return 1e3 * run.extra["input_wait_s"] / run.units
