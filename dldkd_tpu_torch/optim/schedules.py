"""Learning-rate and distillation-decay schedules (port of
dldkd_tpu/optim/schedules.py).

LR schedules reproduce the reference `_LRSchedule` family
(method/optimization.py:35-184): step -> multiplier, evaluated in float32
as the JAX package evaluates them inside its jitted optimizer (numpy
float32 here, on the host). The per-epoch distillation-weight / alpha /
belta decays reproduce method/train.py:73-125 as host floats.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np

f32 = np.float32


def _safe(warmup: float) -> float:
    """Keep the warmup division finite when warmup == 0 (the reference
    short-circuits this case in Python)."""
    return max(warmup, 1e-12)


def _progress(step, t_total: float) -> np.float32:
    return f32(step) / f32(t_total)


# --------------------------------------------------------------------- #
# LR schedules: step -> float32 multiplier
# --------------------------------------------------------------------- #

def warmup_linear(warmup: float, t_total: float) -> Callable:
    """Linear warmup to 1 over `warmup` fraction, then linear decay to 0
    (reference WarmupLinearSchedule, optimization.py:165-175)."""

    def fn(step):
        progress = _progress(step, t_total)
        if progress < f32(warmup):
            return progress / f32(_safe(warmup))
        return np.maximum((progress - f32(1.0)) / f32(warmup - 1.0), f32(0))

    return fn


def warmup_constant(warmup: float, t_total: float) -> Callable:
    def fn(step):
        progress = _progress(step, t_total)
        if progress < f32(warmup):
            return progress / f32(_safe(warmup))
        return f32(1.0)

    return fn


def warmup_cosine(warmup: float, t_total: float, cycles: float = 0.5
                  ) -> Callable:
    def fn(step):
        progress = _progress(step, t_total)
        if progress < f32(warmup):
            return progress / f32(_safe(warmup))
        after = (progress - f32(warmup)) / f32(1.0 - warmup)
        return f32(0.5) * (f32(1.0) + np.cos(f32(math.pi * cycles * 2.0)
                                             * after))

    return fn


def warmup_cosine_hard_restarts(warmup: float, t_total: float,
                                cycles: float = 1.0) -> Callable:
    """Cosine decays restarting `cycles` times after one shared warmup
    (reference WarmupCosineWithHardRestartsSchedule,
    optimization.py:113-129)."""

    def fn(step):
        progress = _progress(step, t_total)
        if progress < f32(warmup):
            return progress / f32(_safe(warmup))
        after = (progress - f32(warmup)) / f32(1.0 - warmup)
        return f32(0.5) * (f32(1.0) + np.cos(
            f32(math.pi) * np.mod(f32(cycles) * after, f32(1.0))))

    return fn


def warmup_cosine_warmup_restarts(warmup: float, t_total: float,
                                  cycles: float = 1.0) -> Callable:
    """Training split into `cycles` equal parts, each with its own
    warmup + cosine decay (reference WarmupCosineWithWarmupRestartsSchedule,
    optimization.py:132-151; the reference pre-scales warmup by cycles)."""
    warmup = warmup * cycles

    def fn(step):
        progress = np.mod(_progress(step, t_total) * f32(cycles), f32(1.0))
        if progress < f32(warmup):
            return progress / f32(_safe(warmup))
        after = (progress - f32(warmup)) / f32(1.0 - warmup)
        return f32(0.5) * (f32(1.0) + np.cos(f32(math.pi) * after))

    return fn


def constant_lr(*_args, **_kw) -> Callable:
    return lambda step: f32(1.0)


SCHEDULES = {
    None: constant_lr,
    "none": constant_lr,
    "warmup_cosine": warmup_cosine,
    "warmup_constant": warmup_constant,
    "warmup_linear": warmup_linear,
    "warmup_cosine_hard_restarts": warmup_cosine_hard_restarts,
    "warmup_cosine_warmup_restarts": warmup_cosine_warmup_restarts,
}


def make_lr_schedule(name: Optional[str], warmup: float,
                     t_total: float) -> Callable:
    if name not in SCHEDULES:
        raise ValueError(f"unknown LR schedule {name!r}")
    return SCHEDULES[name](warmup, t_total)


# --------------------------------------------------------------------- #
# Per-epoch decays (host floats; reference method/train.py:73-125)
# --------------------------------------------------------------------- #

def distill_weight(decay: Optional[str], epoch: int, *, exponential_k: float,
                   linear_k: float, linear_b: float, sigmoid_k: float) -> float:
    """KD loss weight for this epoch (train.py:73-82)."""
    if decay in (None, "None"):
        return 1.0
    if decay == "exp":
        return exponential_k ** epoch
    if decay == "linear":
        return max(linear_k * epoch + linear_b, 0.05)
    if decay == "sigmoid":
        return sigmoid_k / (sigmoid_k + math.exp(epoch * 100.0 / sigmoid_k))
    raise ValueError(f"unknown distill_loss_decay {decay!r}")


def _bounded_decay(decay: Optional[str], epoch: int, initial: float,
                   floor: float, n_epoch: int, exponential_k: float,
                   sigmoid_k: float) -> float:
    if decay in (None, "None"):
        return initial
    if decay == "exp":
        return max(initial * (exponential_k ** epoch), floor)
    if decay == "linear":
        return max(initial + ((floor - initial) / n_epoch) * epoch, floor)
    if decay == "sigmoid":
        return max(initial * (sigmoid_k / (sigmoid_k + math.exp(
            epoch * 100.0 / sigmoid_k))), floor)
    if decay == "cosine":
        return max(floor + 0.5 * (initial - floor)
                   * (1 + math.cos(math.pi * epoch / n_epoch)), floor)
    raise ValueError(f"unknown decay {decay!r}")


def alpha_schedule(decay: Optional[str], epoch: int, initial_alpha: float,
                   n_epoch: int, exponential_k: float,
                   self_distil_sigmoid_k: float) -> float:
    """Soft-NCE partition threshold for this epoch (train.py:85-104).
    The reference's min_alpha is 0 on both branches of its if/else."""
    return _bounded_decay(decay, epoch, initial_alpha, 0.0, n_epoch,
                          exponential_k, self_distil_sigmoid_k)


def belta_schedule(decay: Optional[str], epoch: int, initial_belta: float,
                   n_epoch: int, exponential_k: float,
                   self_distil_sigmoid_k: float) -> float:
    """GT/soft mixing weight for this epoch (train.py:106-125);
    floor 0.5 when the initial value is >= 0.5."""
    floor = 0.0 if initial_belta < 0.5 else 0.5
    return _bounded_decay(decay, epoch, initial_belta, floor, n_epoch,
                          exponential_k, self_distil_sigmoid_k)
