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
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


class LinearInputProj(nn.Module):
    """LayerNorm -> Dropout -> Linear -> ReLU input projection."""

    def __init__(self, in_dim: int, out_dim: int, dropout: float):
        super().__init__()
        self.LayerNorm = nn.LayerNorm(in_dim, eps=1e-5)
        self.net = nn.Sequential(nn.Dropout(dropout),
                                 nn.Linear(in_dim, out_dim), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(self.LayerNorm(x))


class TrainablePositionalEncoding(nn.Module):
    """Learned position embedding + LayerNorm + Dropout."""

    def __init__(self, max_len: int, hidden: int, dropout: float):
        super().__init__()
        self.position_embeddings = nn.Embedding(max_len, hidden)
        self.LayerNorm = nn.LayerNorm(hidden, eps=1e-5)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pos = self.position_embeddings.weight[: x.shape[1]]
        return self.dropout(self.LayerNorm(x + pos[None]))


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
        self.dropout = nn.Dropout(dropout)


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
        self.attn_dropout = nn.Dropout(attn_dropout)
        self.output = _SelfOutput(hidden, hidden_dropout)

    def forward(self, x: torch.Tensor,                 # (B, L, D)
                mask: Optional[torch.Tensor] = None    # (B, L) 1=valid
                ) -> torch.Tensor:
        b, l, hidden = x.shape
        d_head = hidden // self.n_heads

        def heads(lin):
            return lin(x).reshape(b, l, self.n_heads, d_head).transpose(1, 2)

        q, k, v = heads(self.self.query), heads(self.self.key), \
            heads(self.self.value)
        scores = q @ k.transpose(-1, -2) / math.sqrt(d_head)
        if mask is not None:
            scores = scores + (1.0 - mask[:, None, None, :]) * -10000.0
        probs = self.attn_dropout(torch.softmax(scores, dim=-1))
        ctx = (probs @ v).transpose(1, 2).reshape(b, l, hidden)
        out = self.output.dropout(self.output.dense(ctx))
        return self.output.LayerNorm(out + x)
