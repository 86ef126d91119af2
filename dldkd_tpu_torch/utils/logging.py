"""Logging + metrics writers (port of dldkd_tpu/utils/logging.py).

The reference's observability surface (SURVEY.md S5.5): stderr logging
with a file handler (`performance.log`), an append-only train.log.txt
(written by train.py), and per-step scalars: always to metrics.jsonl,
and to TensorBoard when its writer imports.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional


def setup_logging(results_dir: Optional[str] = None,
                  name: str = "performance") -> logging.Logger:
    logging.basicConfig(
        format="%(asctime)s.%(msecs)03d:%(levelname)s:%(name)s - %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S", level=logging.INFO)
    logger = logging.getLogger("dldkd_tpu_torch")
    # INFO reaches the run's file log whatever the root logger's level
    logger.setLevel(logging.INFO)
    for h in [h for h in logger.handlers
              if isinstance(h, logging.FileHandler)]:
        # one run's file log per process: drop an earlier run's handler
        logger.removeHandler(h)
        h.close()
    if results_dir:
        os.makedirs(results_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(results_dir, f"{name}.log"))
        fh.setFormatter(logging.Formatter(
            "%(asctime)s:%(levelname)s:%(name)s - %(message)s"))
        logger.addHandler(fh)
    return logger


class MetricsWriter:
    """Per-step scalar sink: metrics.jsonl (+ TensorBoard if available)."""

    def __init__(self, log_dir: str, tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir)
            except Exception:
                self._tb = None

    def scalars(self, tag_values: Dict[str, float], step: int) -> None:
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in tag_values.items()})
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in tag_values.items():
                self._tb.add_scalar(k, float(v), step)

    def flush(self):
        self._f.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self.flush()
        self._f.close()
        if self._tb is not None:
            self._tb.close()
