"""search.call_ms: the median host ms of one `Retriever.search` call in
the window, from the call to its results on the host."""


def read(run):
    if run.units == 0:
        return None
    return run.extra.get("call_ms")
