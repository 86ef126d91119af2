"""Wall-clock / scalar meters (port of dldkd_tpu/utils/meters.py;
reference AverageMeter, utils/basic_utils.py:348-373)."""

from __future__ import annotations


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.max = float("-inf")
        self.min = float("inf")

    def update(self, val: float, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.max = max(self.max, val)
        self.min = min(self.min, val)

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def __repr__(self):
        return f"{self.avg:.4f}"
