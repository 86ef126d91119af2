"""Stacked-branch training towers: both branches as one batched
computation (port of dldkd_tpu/models/stacked.py).

The two branches of a dual-branch DLDKD with one hidden size have the same
shapes. The sequential training forward runs their towers one after the
other; here each op runs once over a leading axis of 2: the branches'
weights are stacked at each call (`torch.stack` on the live parameters, so
the gradient reaches both branches' parameters), the Linears become one
batched product over (2, out, in) weights, a LayerNorm normalizes and then
applies each branch's scale and bias, and attention folds the branch axis
into the batch. The parameters keep the two-branch layout, so checkpoints,
the converter and the validation see no difference.

Semantics: the same math per branch as the sequential forward, with the
same rounding points in each compute dtype (components.py), so the
deterministic outputs agree to rounding. The dropout stream differs: the
sequential forward draws one mask per module and branch from the
generator, in module order (context towers, then query towers); here each
stacked op draws one mask of the stacked (2, ...) shape, in the same op
order (context tower, then query tower). Different draws from the same
generator state, the same distribution, as the JAX package's stacked path
differs from its sequential one (stacked.py:14-20 there).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from dldkd_tpu_torch.models.components import (Generator, dense, dropout,
                                               layer_norm)
from dldkd_tpu_torch.ops.masking import mask_logits

Pair = Tuple[torch.Tensor, torch.Tensor]


def can_stack(cfg) -> bool:
    """Stacking needs two branches with one shared hidden size."""
    return bool(cfg.double_branch
                and cfg.inheritance_hidden == cfg.exploration_hidden)


def _stacked(mods: Sequence, name: str) -> torch.Tensor:
    return torch.stack([getattr(m, name) for m in mods])


def _bcast(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """(2, F) per-branch vector -> (2, 1, ..., 1, F) against ndim dims."""
    return t.reshape(t.shape[:1] + (1,) * (ndim - 2) + t.shape[1:])


def _linear(lins: Sequence, x: torch.Tensor, dtype) -> torch.Tensor:
    """Both branches' Linear on x (2, ..., in): `components.dense` on the
    (2, out, in) weights, one batched product."""
    w = _stacked(lins, "weight")
    b = None if lins[0].bias is None else _stacked(lins, "bias")[:, None]
    y = dense(x.reshape(2, -1, x.shape[-1]), w, b, dtype)
    return y.reshape(x.shape[:-1] + (w.shape[1],))


def _layer_norm(norms: Sequence, x: torch.Tensor, dtype) -> torch.Tensor:
    """Both branches' LayerNorm on x (2, ...), or on a shared x (1, ...)
    normalized once: `components.layer_norm` with each branch's scale
    and bias."""
    return layer_norm(x, _bcast(_stacked(norms, "weight"), x.dim()),
                      _bcast(_stacked(norms, "bias"), x.dim()),
                      norms[0].eps, dtype)


class _Stack:
    """Both branches' modules and the stacked forward's state (compute
    dtype, heads, training mode, generator)."""

    def __init__(self, model, training: bool, generator: Generator):
        self.brs = model.branches
        self.dtype = self.brs[0].dtype
        self.n_heads = model.config.n_heads
        self.training = training
        self.generator = generator

    def mods(self, path: str):
        return [br.get_submodule(path) for br in self.brs]

    def drop(self, x: torch.Tensor, p: float) -> torch.Tensor:
        # the branch axis comes first: the batch is axis 1
        return dropout(x, p, self.training, self.generator, batch_axis=1)

    def input_proj(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """LinearInputProj: the shared input normalized once, then each
        branch's affine, dropout, Linear and ReLU."""
        y = _layer_norm(self.mods(f"{name}.LayerNorm"), x[None], self.dtype)
        y = self.drop(y, self.brs[0].get_submodule(name).net[0].p)
        return torch.relu(_linear(self.mods(f"{name}.net.1"), y,
                                  self.dtype))

    def pos_embed(self, name: str, x: torch.Tensor) -> torch.Tensor:
        pos = _stacked(self.mods(f"{name}.position_embeddings"),
                       "weight")[:, None, : x.shape[2]]
        if self.dtype is not None:
            pos = pos.to(self.dtype)
        y = _layer_norm(self.mods(f"{name}.LayerNorm"), x + pos, self.dtype)
        return self.drop(y, self.brs[0].get_submodule(name).dropout.p)

    def attention(self, name: str, x: torch.Tensor,
                  mask: Optional[torch.Tensor]) -> torch.Tensor:
        """AttentionBlock over x (2, B, L, H), the branch axis folded into
        the batch of the score products."""
        _, b, l, hidden = x.shape
        h = self.n_heads
        d_head = hidden // h
        enc = self.brs[0].get_submodule(name)

        def heads(part):
            y = _linear(self.mods(f"{name}.self.{part}"), x, self.dtype)
            return y.reshape(2 * b, l, h, d_head).transpose(1, 2)

        q, k, v = heads("query"), heads("key"), heads("value")
        scores = (q @ k.transpose(-1, -2) / math.sqrt(d_head)
                  ).reshape(2, b, h, l, l)
        if mask is not None:
            scores = scores + (1.0 - mask[None, :, None, None, :]) * -10000.0
        probs = self.drop(torch.softmax(scores, dim=-1),
                          enc.attn_dropout.p).reshape(2 * b, h, l, l)
        ctx = (probs @ v.to(probs.dtype)).transpose(1, 2).reshape(
            2, b, l, hidden)
        out = self.drop(_linear(self.mods(f"{name}.output.dense"), ctx,
                                self.dtype), enc.output.dropout.p)
        return _layer_norm(self.mods(f"{name}.output.LayerNorm"), out + x,
                           self.dtype)

    def context(self, feat, mask) -> torch.Tensor:
        """Branch.encode_context for both branches: (2, Nv, Lv, H)."""
        x = self.input_proj("visual_input_proj", feat)
        x = self.pos_embed("visual_pos_embed", x)
        x = self.attention("visual_encoder", x, mask)
        return _linear(self.mods("out_mapping_linear"), x, self.dtype)

    def query(self, feat, mask) -> torch.Tensor:
        """Branch.encode_query for both branches: (2, Nq, H)."""
        x = self.input_proj("query_input_proj", feat)
        x = self.pos_embed("query_pos_embed", x)
        x = self.attention("query_encoder", x, mask)
        att = _linear(self.mods("modular_vector_mapping"), x, self.dtype)
        att = torch.softmax(mask_logits(att, mask[None, :, :, None]), dim=2)
        return (att * x).sum(dim=2)


def encode_stacked(model, video_feat, video_mask, query_feat, query_mask,
                   generator: Generator = None
                   ) -> Tuple[Pair, Pair]:
    """The training forward of `model` (a DLDKD) with both branches'
    towers run as one stacked computation: ((inher_ctx, explore_ctx),
    (inher_q, explore_q)), as `model(...)` returns. In training mode with
    dropout on, `generator` gives every mask."""
    if not can_stack(model.config):
        raise ValueError("stacked towers need double_branch with equal "
                         "hidden sizes")
    st = _Stack(model, model.training, generator)
    ctx = st.context(video_feat, video_mask)
    qry = st.query(query_feat, query_mask)
    return (ctx[0], ctx[1]), (qry[0], qry[1])
