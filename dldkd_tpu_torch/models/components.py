"""Building blocks of the DLDKD towers (port of
dldkd_tpu/models/components.py).

Attribute names are the reference PyTorch names (the mapping documented at
dldkd_tpu/convert.py:8-20), so a reference `state_dict` and one converted
from a JAX checkpoint both load with strict=True:

  LinearInputProj             LayerNorm, net.1 (Dropout -> Linear -> ReLU)
  TrainablePositionalEncoding position_embeddings, LayerNorm
  AttentionBlock              self.{query,key,value}, output.{dense,LayerNorm}

LayerNorm eps is 1e-5; the attention key mask is added as
(1 - mask) * -10000; dropout sits where the JAX modules put it (after the
input LayerNorm, after the positional LayerNorm, on the attention
probabilities, and on the output projection before the residual).

Dropout draws its masks from a `torch.Generator` the caller passes to
`forward`, never from the global RNG, so a training run is reproducible
from its generator state alone (and resumes exactly from a checkpoint of
it). As in Flax, each value is kept with probability 1 - p and scaled by
1 / (1 - p); in eval mode, or at p = 0, dropout is the identity.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


Generator = Optional[torch.Generator]


class Dropout(nn.Module):
    """Inverted dropout whose masks come from an explicit generator."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)

    def forward(self, x: torch.Tensor, generator: Generator = None
                ) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if generator is None:
            raise ValueError("dropout in training mode needs a generator")
        keep = torch.rand(x.shape, generator=generator, device=x.device,
                          dtype=torch.float32) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))

    def extra_repr(self) -> str:
        return f"p={self.p}"


class LinearInputProj(nn.Module):
    """LayerNorm -> Dropout -> Linear -> ReLU input projection."""

    def __init__(self, in_dim: int, out_dim: int, dropout: float):
        super().__init__()
        self.LayerNorm = nn.LayerNorm(in_dim, eps=1e-5)
        self.net = nn.Sequential(Dropout(dropout),
                                 nn.Linear(in_dim, out_dim), nn.ReLU())

    def forward(self, x: torch.Tensor, generator: Generator = None
                ) -> torch.Tensor:
        drop, linear, relu = self.net
        return relu(linear(drop(self.LayerNorm(x), generator)))


class TrainablePositionalEncoding(nn.Module):
    """Learned position embedding + LayerNorm + Dropout."""

    def __init__(self, max_len: int, hidden: int, dropout: float):
        super().__init__()
        self.position_embeddings = nn.Embedding(max_len, hidden)
        self.LayerNorm = nn.LayerNorm(hidden, eps=1e-5)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor, generator: Generator = None
                ) -> torch.Tensor:
        pos = self.position_embeddings.weight[: x.shape[1]]
        return self.dropout(self.LayerNorm(x + pos[None]), generator)


class _SelfAttention(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)


class _SelfOutput(nn.Module):
    def __init__(self, hidden: int, dropout: float):
        super().__init__()
        self.dense = nn.Linear(hidden, hidden)
        self.LayerNorm = nn.LayerNorm(hidden, eps=1e-5)
        self.dropout = Dropout(dropout)


class AttentionBlock(nn.Module):
    """One multi-head self-attention sublayer with a residual LayerNorm
    (attention only: the encoders have no feed-forward sublayer)."""

    def __init__(self, hidden: int, n_heads: int, attn_dropout: float,
                 hidden_dropout: float):
        super().__init__()
        if hidden % n_heads:
            raise ValueError(
                f"hidden {hidden} not divisible by n_heads {n_heads}")
        self.n_heads = n_heads
        self.self = _SelfAttention(hidden)
        self.attn_dropout = Dropout(attn_dropout)
        self.output = _SelfOutput(hidden, hidden_dropout)

    def forward(self, x: torch.Tensor,                 # (B, L, D)
                mask: Optional[torch.Tensor] = None,   # (B, L) 1=valid
                generator: Generator = None) -> torch.Tensor:
        b, l, hidden = x.shape
        d_head = hidden // self.n_heads

        def heads(lin):
            return lin(x).reshape(b, l, self.n_heads, d_head).transpose(1, 2)

        q, k, v = heads(self.self.query), heads(self.self.key), \
            heads(self.self.value)
        scores = q @ k.transpose(-1, -2) / math.sqrt(d_head)
        if mask is not None:
            scores = scores + (1.0 - mask[:, None, None, :]) * -10000.0
        probs = self.attn_dropout(torch.softmax(scores, dim=-1), generator)
        ctx = (probs @ v).transpose(1, 2).reshape(b, l, hidden)
        out = self.output.dropout(self.output.dense(ctx), generator)
        return self.output.LayerNorm(out + x)
