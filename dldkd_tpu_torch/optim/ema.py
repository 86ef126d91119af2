"""Parameter EMA (port of dldkd_tpu/optim/ema.py; reference
optimization.py:187-220, unused by the shipped train path but part of the
optimizer toolkit).

The shadow is a {name: tensor} dict beside the model's parameters;
swap/restore exchange dicts, as the JAX package exchanges trees."""

from __future__ import annotations

from typing import Dict, Mapping

import torch

Params = Dict[str, torch.Tensor]


def ema_init(params: Mapping[str, torch.Tensor]) -> Params:
    """Shadow initialised to a copy of the parameters."""
    return {k: v.detach().clone() for k, v in params.items()}


def ema_update(shadow: Mapping[str, torch.Tensor],
               params: Mapping[str, torch.Tensor], step,
               decay: float = 0.999) -> Params:
    """shadow <- (1-d)*params + d*shadow with the reference's warm-started
    decay d = min(decay, (1+step)/(10+step)) (optimization.py:199-206),
    in float32."""
    step = torch.as_tensor(step, dtype=torch.float32)
    d = torch.clamp((1.0 + step) / (10.0 + step), max=decay)
    return {k: (1.0 - d.to(s.device)) * params[k].detach()
            + d.to(s.device) * s for k, s in shadow.items()}


def ema_swap(shadow: Params, params: Params):
    """(eval_params, saved_params): use the shadow for eval, keep the live
    params to restore afterwards (reference assign/resume,
    optimization.py:208-220)."""
    return shadow, params
