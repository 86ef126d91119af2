"""Building blocks of the DLDKD towers (port of
dldkd_tpu/models/components.py).

Attribute names are the reference PyTorch names (the mapping documented at
dldkd_tpu/convert.py:8-20), so a reference `state_dict` and one converted
from a JAX checkpoint both load with strict=True:

  LinearInputProj             LayerNorm, net.1 (Dropout -> Linear -> ReLU)
  TrainablePositionalEncoding position_embeddings, LayerNorm
  AttentionBlock              self.{query,key,value}, output.{dense,LayerNorm}
                              (BertAttention)
  FeedForward                 intermediate.dense, output.{dense,LayerNorm}
                              (BertIntermediate + BertOutput)
  TransformerBlock            attention.* (an AttentionBlock, when
                              use_self_attention), then FeedForward's
                              names (BertLayer)

LayerNorm eps is 1e-5; the attention key mask is added as
(1 - mask) * -10000; dropout sits where the JAX modules put it (after the
input LayerNorm, after the positional LayerNorm, on the attention
probabilities, and on the output projection before the residual).

Dropout draws its masks from a `torch.Generator` the caller passes to
`forward`, never from the global RNG, so a training run is reproducible
from its generator state alone (and resumes exactly from a checkpoint of
it). As in Flax, each value is kept with probability 1 - p and scaled by
1 / (1 - p); in eval mode, or at p = 0, dropout is the identity.

Compute dtype (`ModelConfig.dtype`, the `dtype` argument below): the
parameters stay float32 either way. For "float32" (dtype None) every op
runs in the dtype of its inputs and parameters (a float64 copy of the
model computes in float64). For "bfloat16"
each op rounds where the flax module with `dtype=jnp.bfloat16` rounds
(flax 0.12):
  - a Dense casts input, kernel and bias to bf16, takes the product in
    bf16 and adds the bias in bf16: two roundings (`dense` below, not a
    fused-bias `F.linear`);
  - a LayerNorm takes its statistics and normalizes in f32 and rounds to
    bf16 once at the end (`layer_norm`);
  - `x + pos.astype(bf16)` is a bf16 add;
  - in attention the scores are bf16 until the f32 key mask is added,
    which promotes them: softmax, dropout and `probs @ v` run in f32 (v
    promoted), and the output Dense rounds back to bf16;
  - the query pooling's mask_logits promotes the bf16 logits to f32, so
    the pooled query comes out f32; the video tower ends in a bf16 Dense.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn


class BatchShard(NamedTuple):
    """A generator for one shard of a data-parallel batch
    (parallel/train_dp.py): each dropout mask is drawn at the global
    batch's shape, `count` times this shard's rows on the batch axis, and
    the shard keeps its rows [index * n, (index + 1) * n). Every process
    draws the same numbers, so the masks are the single-device step's and
    the generators stay in lockstep."""

    generator: torch.Generator
    index: int
    count: int


Generator = Optional[Union[torch.Generator, BatchShard]]
Dtype = Optional[torch.dtype]


def compute_dtype(name: str) -> Dtype:
    """`ModelConfig.dtype` -> the modules' compute dtype: None for
    "float32" (no casts), torch.bfloat16 for "bfloat16"."""
    return {"float32": None, "bfloat16": torch.bfloat16}[name]


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor], dtype: Dtype) -> torch.Tensor:
    """flax `nn.Dense(dtype=dtype)` on torch's (out, in) weight. weight and
    bias may carry leading axes that broadcast against x's (the stacked
    branches' (2, out, in) and (2, 1, out), models/stacked.py)."""
    if dtype is None and weight.dim() == 2:
        return F.linear(x, weight, bias)
    if dtype is not None:
        x, weight = x.to(dtype), weight.to(dtype)
        bias = None if bias is None else bias.to(dtype)
    y = x @ weight.mT
    return y if bias is None else y + bias


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float, dtype: Dtype) -> torch.Tensor:
    """flax `nn.LayerNorm(dtype=dtype)` over the last axis: statistics and
    affine in f32 for bf16, one rounding to `dtype` at the end. weight and
    bias may carry leading axes that broadcast against x's (each stacked
    branch's scale and bias on one normalization)."""
    if dtype is not None:
        x = x.float()
    if weight.dim() == 1:
        y = F.layer_norm(x, weight.shape, weight, bias, eps)
    else:
        y = F.layer_norm(x, weight.shape[-1:], eps=eps) * weight + bias
    return y if dtype is None else y.to(dtype)


def _dense(lin: nn.Linear, x: torch.Tensor, dtype: Dtype) -> torch.Tensor:
    return dense(x, lin.weight, lin.bias, dtype)


def _ln(norm: nn.LayerNorm, x: torch.Tensor, dtype: Dtype) -> torch.Tensor:
    return layer_norm(x, norm.weight, norm.bias, norm.eps, dtype)


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Generator, batch_axis: int = 0) -> torch.Tensor:
    """Inverted dropout with the mask drawn from `generator` (uniform f32
    draws of x's shape, kept where >= p). A `BatchShard` draws at the
    global batch's shape on `batch_axis` and keeps this shard's rows."""
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training mode needs a generator")
    shape = list(x.shape)
    if isinstance(generator, BatchShard):
        shape[batch_axis] *= generator.count
        keep = torch.rand(shape, generator=generator.generator,
                          device=x.device, dtype=torch.float32).narrow(
            batch_axis, generator.index * x.shape[batch_axis],
            x.shape[batch_axis]) >= p
    else:
        keep = torch.rand(shape, generator=generator, device=x.device,
                          dtype=torch.float32) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


class Dropout(nn.Module):
    """Inverted dropout whose masks come from an explicit generator."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)

    def forward(self, x: torch.Tensor, generator: Generator = None
                ) -> torch.Tensor:
        return dropout(x, self.p, self.training, generator)

    def extra_repr(self) -> str:
        return f"p={self.p}"


class LinearInputProj(nn.Module):
    """LayerNorm -> Dropout -> Linear -> ReLU input projection."""

    def __init__(self, in_dim: int, out_dim: int, dropout: float,
                 dtype: Dtype = None):
        super().__init__()
        self.dtype = dtype
        self.LayerNorm = nn.LayerNorm(in_dim, eps=1e-5)
        self.net = nn.Sequential(Dropout(dropout),
                                 nn.Linear(in_dim, out_dim), nn.ReLU())

    def forward(self, x: torch.Tensor, generator: Generator = None
                ) -> torch.Tensor:
        drop, linear, relu = self.net
        x = drop(_ln(self.LayerNorm, x, self.dtype), generator)
        return relu(_dense(linear, x, self.dtype))


class TrainablePositionalEncoding(nn.Module):
    """Learned position embedding + LayerNorm + Dropout."""

    def __init__(self, max_len: int, hidden: int, dropout: float,
                 dtype: Dtype = None):
        super().__init__()
        self.dtype = dtype
        self.position_embeddings = nn.Embedding(max_len, hidden)
        self.LayerNorm = nn.LayerNorm(hidden, eps=1e-5)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor, generator: Generator = None
                ) -> torch.Tensor:
        pos = self.position_embeddings.weight[: x.shape[1]]
        if self.dtype is not None:
            pos = pos.to(self.dtype)
        return self.dropout(_ln(self.LayerNorm, x + pos[None], self.dtype),
                            generator)


class _SelfAttention(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)


class _SelfOutput(nn.Module):
    def __init__(self, hidden: int, dropout: float, in_dim: int = 0):
        super().__init__()
        self.dense = nn.Linear(in_dim or hidden, hidden)
        self.LayerNorm = nn.LayerNorm(hidden, eps=1e-5)
        self.dropout = Dropout(dropout)


class AttentionBlock(nn.Module):
    """One multi-head self-attention sublayer with a residual LayerNorm
    (attention only: the encoders have no feed-forward sublayer)."""

    def __init__(self, hidden: int, n_heads: int, attn_dropout: float,
                 hidden_dropout: float, dtype: Dtype = None):
        super().__init__()
        if hidden % n_heads:
            raise ValueError(
                f"hidden {hidden} not divisible by n_heads {n_heads}")
        self.n_heads = n_heads
        self.dtype = dtype
        self.self = _SelfAttention(hidden)
        self.attn_dropout = Dropout(attn_dropout)
        self.output = _SelfOutput(hidden, hidden_dropout)

    def forward(self, x: torch.Tensor,                 # (B, L, D)
                mask: Optional[torch.Tensor] = None,   # (B, L) 1=valid
                generator: Generator = None) -> torch.Tensor:
        b, l, hidden = x.shape
        d_head = hidden // self.n_heads

        def heads(lin):
            return _dense(lin, x, self.dtype).reshape(
                b, l, self.n_heads, d_head).transpose(1, 2)

        q, k, v = heads(self.self.query), heads(self.self.key), \
            heads(self.self.value)
        scores = q @ k.transpose(-1, -2) / math.sqrt(d_head)
        if mask is not None:
            scores = scores + (1.0 - mask[:, None, None, :]) * -10000.0
        probs = self.attn_dropout(torch.softmax(scores, dim=-1), generator)
        ctx = (probs @ v.to(probs.dtype)).transpose(1, 2).reshape(b, l,
                                                                  hidden)
        out = self.output.dropout(_dense(self.output.dense, ctx, self.dtype),
                                  generator)
        return _ln(self.output.LayerNorm, out + x, self.dtype)


class _Intermediate(nn.Module):
    def __init__(self, hidden: int, intermediate: int):
        super().__init__()
        self.dense = nn.Linear(hidden, intermediate)


class FeedForward(nn.Module):
    """ReLU feed-forward sublayer with a residual LayerNorm (port of the
    JAX FeedForward, dldkd_tpu/models/components.py:126-148): Linear(
    intermediate) -> ReLU -> Linear(hidden) -> Dropout -> LN(h + x)."""

    def __init__(self, hidden: int, intermediate: int, dropout: float,
                 dtype: Dtype = None):
        super().__init__()
        self.dtype = dtype
        self.intermediate = _Intermediate(hidden, intermediate)
        self.output = _SelfOutput(hidden, dropout, in_dim=intermediate)

    def forward(self, x: torch.Tensor, generator: Generator = None
                ) -> torch.Tensor:
        h = torch.relu(_dense(self.intermediate.dense, x, self.dtype))
        h = self.output.dropout(_dense(self.output.dense, h, self.dtype),
                                generator)
        return _ln(self.output.LayerNorm, h + x, self.dtype)


class TransformerBlock(FeedForward):
    """Self-attention (optional) then the feed-forward sublayer (port of
    the JAX TransformerBlock, components.py:150-183; reference BertLayer).
    use_self_attention=False is the reference's feed-forward-only mode."""

    def __init__(self, hidden: int, intermediate: int, n_heads: int,
                 attn_dropout: float, hidden_dropout: float,
                 use_self_attention: bool = True, dtype: Dtype = None):
        super().__init__(hidden, intermediate, hidden_dropout, dtype)
        self.attention = (AttentionBlock(hidden, n_heads, attn_dropout,
                                         hidden_dropout, dtype)
                          if use_self_attention else None)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Generator = None) -> torch.Tensor:
        if self.attention is not None:
            x = self.attention(x, mask, generator)
        return super().forward(x, generator)
