"""Masking / normalization primitives (port of dldkd_tpu/ops/masking.py)."""

from __future__ import annotations

import torch

# The reference's sentinel for masked-out logits (method/model.py:444-445).
NEG_INF = -1e10


def mask_logits(target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """target * mask + (1 - mask) * NEG_INF — the reference's affine form
    (method/model.py:444-445), not a `where`: valid positions keep their
    value, masked ones become -1e10."""
    return target * mask + (1.0 - mask) * NEG_INF


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12
                 ) -> torch.Tensor:
    """x / max(||x||, eps), rounding where `jnp.linalg.norm` rounds.

    For a low-precision input (bf16) JAX multiplies in the input dtype,
    accumulates the sum of squares in f32 and rounds it back, then takes
    the sqrt and the divide each rounded to the input dtype (documented at
    dldkd_tpu/ops/pallas/query_tower.py:144-157). Each torch op on a bf16
    tensor below computes in f32 and rounds once, which reproduces those
    rounding points. For f32 inputs every step is plain f32."""
    if x.dtype == torch.float32:
        norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
        return x / torch.clamp(norm, min=eps)
    sq = x * x                                              # input dtype
    s = sq.float().sum(dim=dim, keepdim=True).to(x.dtype)   # f32 sum, rounded
    norm = torch.sqrt(s)                                    # input dtype
    return x / torch.clamp(norm, min=eps)
