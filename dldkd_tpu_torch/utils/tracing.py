"""The port's spans and counters, recorded only while a torch profiler
records.

`span(name)` is a `torch.profiler.record_function` range while a profiler
records and one shared no-op context otherwise, so a span costs a flag
read when nothing is traced. A recorded span lands in the profiler's
chrome trace beside the host's ops and the card's kernels and copies, on
one clock; spans nest by the host thread's call stack. `traced(name)`
wraps a whole function in one. Names are `<layer>/<part>`:

  eval/run, eval/pack_weights, eval/corpus, eval/score, eval/rank,
  eval/h2d, eval/stage          the eval engine (evaluate.py,
                                ops/fast_eval.tower_weights); eval/stage
                                on the staging worker thread
  serve/h2d, serve/topk, serve/d2h
                                serving (serving.py): each query batch's
                                staging (slot wait, fill, queued copy and
                                zeroing), each topk_lowest_index, the
                                results' copies to the host
  kernels/query_tower, kernels/context_tower, kernels/sim_max,
  kernels/sim_max_int8, kernels/sim_max_exact, kernels/quantize_q8
                                one call into a hand-written kernel's
                                wrapper (ops/kernels/), CUDA or plain
  train_step/forward_losses, train_step/backward, train_step/optimizer
                                the parts of train.train_step

`count(name, n)` adds to an in-memory total, also only while a profiler
records, so `counts()` holds the totals of the profiled stretch:
eval.h2d_bytes, the bytes the eval engines hand to the device (padded
rows included), and eval.h2d_pinned_bytes, those of them staged through a
pinned slot (on a CUDA device only); serve.h2d_bytes, the bytes of the
query rows serving hands to the device, and serve.padded_rows, the
padding rows it zeroes there. `start_profile` sets the totals to
zero and profiles every thread, the staging worker's too; `stop_profile`
writes the chrome trace as trace.json and the totals as counts.json.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
from typing import Dict

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

_NOOP = contextlib.nullcontext()
_COUNTS: Dict[str, int] = {}


def recording() -> bool:
    """True while a torch profiler records: the flag torch.profiler sets
    when it starts and clears when it stops."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """A profiler range named `name` while a profiler records, else the
    shared no-op context."""
    if recording():
        return record_function(name)
    return _NOOP


def traced(name: str):
    """Decorator: every call of the function inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add n to the total `name` while a profiler records."""
    if recording():
        _COUNTS[name] = _COUNTS.get(name, 0) + int(n)


def counts() -> Dict[str, int]:
    """The totals counted since the last `start_profile` (or since the
    process started)."""
    return dict(_COUNTS)


def start_profile(device: torch.device):
    """A started torch profiler of the host's threads and, on a CUDA
    device, the card; the totals start from zero."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    _COUNTS.clear()
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    prof = profile(activities=acts, experimental_config=_ExperimentalConfig(
        profile_all_threads=True))
    prof.start()
    return prof


def stop_profile(prof, directory: str) -> str:
    """Stop `prof`; write its chrome trace as `directory`/trace.json and
    the totals as counts.json beside it. Returns the trace's path."""
    prof.stop()
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "trace.json")
    prof.export_chrome_trace(path)
    with open(os.path.join(directory, "counts.json"), "w") as f:
        json.dump(counts(), f, indent=1, sort_keys=True)
    return path
