"""search.mfu: the whole search call's share of the card's peak while
it runs: the operations of the window's searches (cost/model_ops.
search_work: both query towers and the scores against every frame, real
queries only) over the host seconds of those calls, from each call to
its results on the host, times 495 TFLOP/s, in %. The offered rate does
not enter it: a call that takes less time reads higher."""

from benchmark.cost import model_ops


def read(run):
    if run.units == 0 or not run.work.get("flops") \
            or not run.work.get("call_s"):
        return None
    return 100.0 * run.work["flops"] / (run.work["call_s"]
                                        * model_ops.PEAK_FLOPS)
