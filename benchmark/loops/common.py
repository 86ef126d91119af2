"""What the loops share: the program's model built on the benchmark's
weights, device helpers, and the traced window."""

from __future__ import annotations

import contextlib
import sys
import tempfile
import time
from typing import Dict

import torch
from torch.profiler import record_function

from benchmark import trace

MODEL_KEYS = ("visual_input_size", "query_input_size", "inheritance_hidden",
              "exploration_hidden", "max_ctx_l", "max_desc_l", "input_drop",
              "drop", "n_heads", "initializer_range", "margin",
              "double_branch", "label_style", "dtype", "matmul_precision")


def model_config(cfg: dict):
    from dldkd_tpu_torch.config import ModelConfig

    return ModelConfig(**{k: cfg[k] for k in MODEL_KEYS})


def port_model(cfg: dict, weights: Dict[str, torch.Tensor], device):
    """The program's DLDKD holding a copy of `weights` (strict: every
    name and shape must be the program's)."""
    from dldkd_tpu_torch.models import DLDKD

    with torch.device(device):
        model = DLDKD(model_config(cfg))
    model.load_state_dict(weights, strict=True)
    return model


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device: torch.device) -> int:
    if device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class TracedWindow:
    """torch.profiler over a stretch of calls, marked by the harness's
    `bench/window` range; the device is idle when it starts and when it
    ends."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self.trace = None
        self._range = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        sync(self.device)
        self.prof = profile(activities=acts)
        self.prof.start()
        self._range = record_function(trace.WINDOW)
        self._range.__enter__()

    def stop(self) -> None:
        sync(self.device)
        self._range.__exit__(None, None, None)
        self.prof.stop()
        self.trace = trace.export(self.prof, tempfile.gettempdir())
        self.prof = None


@contextlib.contextmanager
def span(name: str, totals: Dict[str, float]):
    """A harness range around a call into the program: a profiler range
    of that name, and its host seconds added to totals[name]."""
    t0 = time.perf_counter()
    with record_function(name):
        yield
    totals[name] = totals.get(name, 0.0) + time.perf_counter() - t0
