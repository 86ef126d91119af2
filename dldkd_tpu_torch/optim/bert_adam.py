"""BertAdam over a model's named parameters (port of
dldkd_tpu/optim/bert_adam.py).

Reproduces reference `BertAdam` (method/optimization.py:223-343), as the
JAX package's optax transformation does:

  1. each parameter's gradient clipped to norm max_grad_norm on its own
     (coef = max / (norm + 1e-6)), not one global norm;
  2. m <- b1*m + (1-b1)*g ; v <- b2*v + (1-b2)*g^2   (NO bias correction);
  3. update = m / (sqrt(v) + eps) + weight_decay * p, the decay only where
     the mask allows it (not for biases and LayerNorm parameters);
  4. p <- p - lr * schedule(step) * update, where `step` counts the
     PREVIOUS updates (the first step uses schedule(0), LR 0 under warmup).

The state is `step` (an int) and the `m`, `v` dicts keyed by parameter
name; `convert.opt_state_to_jax` / `opt_state_from_jax` carry it to and
from the JAX package's BertAdamState(step, m, v).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch


def default_wd_mask(names) -> Dict[str, bool]:
    """True = apply weight decay. Excludes every bias and all LayerNorm
    parameters: the reference's no_decay name filter ["bias",
    "LayerNorm.bias", "LayerNorm.weight"] (method/train.py:204-207), on the
    port's (reference) parameter names."""
    return {n: not (n.endswith(".bias") or "LayerNorm" in n.split("."))
            for n in names}


class BertAdam:
    """One BertAdam state over `named_params` ({name: Parameter})."""

    def __init__(self, named_params: Mapping[str, torch.nn.Parameter],
                 lr: float, schedule_fn: Optional[Callable] = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.01, max_grad_norm: float = 1.0,
                 wd_mask: Optional[Mapping[str, bool]] = None):
        self.params = dict(named_params)
        self.lr, self.schedule_fn = lr, schedule_fn
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.max_grad_norm = weight_decay, max_grad_norm
        self.wd_mask = (dict(wd_mask) if wd_mask is not None
                        else {n: True for n in self.params})
        self.step_count = 0
        self.m = {n: torch.zeros_like(p, memory_format=torch.contiguous_format)
                  for n, p in self.params.items()}
        self.v = {n: torch.zeros_like(p, memory_format=torch.contiguous_format)
                  for n, p in self.params.items()}

    def multiplier(self) -> np.float32:
        """The LR multiplier of the next update, at the count of previous
        updates, in float32."""
        if self.schedule_fn is None:
            return np.float32(1.0)
        return np.float32(self.schedule_fn(self.step_count))

    @torch.no_grad()
    def step(self, grads: Sequence[Optional[torch.Tensor]]) -> None:
        """Apply one update; grads in the order of `self.params` (None =
        zero gradient: the moments still decay and weight decay applies,
        as for a zero leaf in the JAX tree)."""
        scale = float(np.float32(self.lr) * self.multiplier())
        b1, b2 = self.b1, self.b2
        for (name, p), g in zip(self.params.items(), grads):
            g = torch.zeros_like(p) if g is None else g
            if self.max_grad_norm > 0:
                norm = torch.sqrt(torch.sum(g * g))
                coef = torch.clamp(self.max_grad_norm / (norm + 1e-6),
                                   max=1.0)
                g = g * coef
            m = self.m[name].mul_(b1).add_((1 - b1) * g)
            v = self.v[name].mul_(b2).add_((1 - b2) * g * g)
            wd = self.weight_decay if self.wd_mask[name] else 0.0
            p.add_(-scale * (m / (torch.sqrt(v) + self.eps) + wd * p))
        self.step_count += 1

    def state_dict(self) -> dict:
        return {"step": self.step_count,
                "m": {n: t.clone() for n, t in self.m.items()},
                "v": {n: t.clone() for n, t in self.v.items()}}

    def load_state_dict(self, state: Mapping) -> None:
        self.step_count = int(state["step"])
        for key in ("m", "v"):
            ours = getattr(self, key)
            if set(state[key]) != set(ours):
                raise KeyError(f"optimizer state {key!r}: names differ from "
                               f"the model's parameters")
            for n, t in state[key].items():
                ours[n].copy_(torch.as_tensor(t))
