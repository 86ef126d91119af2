"""Inference-only towers (port of dldkd_tpu/ops/fast_eval.py).

`encode_*_fast` are the model's math restructured for inference, as in the
JAX package: the input LayerNorm's normalization is computed once for all
branches and its affine folds into each branch's projection; they run as
plain PyTorch on any device. `encode_*_best` and `encode_context_q8` are
what the eval and serving call: the CUDA tower kernels
(ops/kernels/query_tower.py) for a CUDA tensor and their plain versions
for a CPU tensor. Unlike the JAX dispatch, f32 configs use
the kernels too: the JAX gate exists only because of TPU VMEM
(dldkd_tpu/ops/fast_eval.py:128-133).

This module is the adapter from the model to the kernels:
`weights_for_branch` / `context_weights_for_branch` read a DLDKD
branch's tower weights into the tuples `ops/kernels/query_tower.py`
takes, and `tower_weights` packs them once per eval or Retriever.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from dldkd_tpu_torch.ops.kernels.query_tower import (Weights, context_towers,
                                                   pack_weights, query_towers)
from dldkd_tpu_torch.ops.masking import mask_logits
from dldkd_tpu_torch.utils.tracing import traced

Pair = Tuple[torch.Tensor, Optional[torch.Tensor]]


def tower_dtype(cfg) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]


def _ln_normalize_f32(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Affine-free LayerNorm in f32 (E[x^2] - E[x]^2, as flax computes)."""
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x * x).mean(-1, keepdim=True) - mu * mu
    return (x - mu) * torch.rsqrt(var + eps)


def _ln(x: torch.Tensor, norm, eps: float = 1e-5) -> torch.Tensor:
    xn = _ln_normalize_f32(x, eps)
    return (xn * norm.weight.float() + norm.bias.float()).to(x.dtype)


def _fold_input_proj(proj, dtype: torch.dtype
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """LinearInputProj -> (W', b') with the LayerNorm affine folded in:
    relu((g * xn + b) @ W + c) == relu(xn @ (g[:, None] * W) + (b @ W + c))
    (dldkd_tpu/ops/fast_eval.py:52-58). W' is (in, out)."""
    g = proj.LayerNorm.weight.detach().float()
    b = proj.LayerNorm.bias.detach().float()
    w = proj.net[1].weight.detach().float().T
    c = proj.net[1].bias.detach().float()
    return (g[:, None] * w).to(dtype), (b @ w + c).to(dtype)


def _encoder_weights(branch, tower: str, dtype: torch.dtype) -> Weights:
    wp, bp = _fold_input_proj(getattr(branch, f"{tower}_input_proj"), dtype)
    pe = getattr(branch, f"{tower}_pos_embed")
    enc = getattr(branch, f"{tower}_encoder")

    def t(p):
        return p.detach().float()

    return (wp, bp, t(pe.position_embeddings.weight), t(pe.LayerNorm.weight),
            t(pe.LayerNorm.bias),
            t(enc.self.query.weight).T, t(enc.self.query.bias),
            t(enc.self.key.weight).T, t(enc.self.key.bias),
            t(enc.self.value.weight).T, t(enc.self.value.bias),
            t(enc.output.dense.weight).T, t(enc.output.dense.bias),
            t(enc.output.LayerNorm.weight), t(enc.output.LayerNorm.bias))


def _branch(model, name: str):
    return model.branches[model.branch_names.index(name)]


def weights_for_branch(model, branch: str, dtype: torch.dtype) -> Weights:
    """Query-tower weight tuple of one branch of a DLDKD module."""
    br = _branch(model, branch)
    return (*_encoder_weights(br, "query", dtype),
            br.modular_vector_mapping.weight.detach().float().T)


def context_weights_for_branch(model, branch: str, dtype: torch.dtype
                               ) -> Weights:
    """Video-tower weight tuple of one branch of a DLDKD module."""
    br = _branch(model, branch)
    om = br.out_mapping_linear
    return (*_encoder_weights(br, "visual", dtype),
            om.weight.detach().float().T, om.bias.detach().float())


def _attention(x: torch.Tensor, mask: torch.Tensor, enc,
               n_heads: int) -> torch.Tensor:
    """Single-block MHA + residual LN (components.AttentionBlock math)."""
    b, l, hdim = x.shape
    d_head = hdim // n_heads

    def proj(lin):
        y = x @ lin.weight.T.to(x.dtype) + lin.bias.to(x.dtype)
        return y.reshape(b, l, n_heads, d_head).transpose(1, 2)

    q, k, v = proj(enc.self.query), proj(enc.self.key), proj(enc.self.value)
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(d_head)
    scores = scores + ((1.0 - mask[:, None, None, :]) * -10000.0
                       ).to(scores.dtype)
    probs = torch.softmax(scores, dim=-1)
    ctx = (probs @ v).transpose(1, 2).reshape(b, l, hdim)
    dense = enc.output.dense
    out = ctx @ dense.weight.T.to(x.dtype) + dense.bias.to(x.dtype)
    return _ln(out + x, enc.output.LayerNorm)


def _fused_projection(model, feat: torch.Tensor, proj_name: str
                      ) -> List[torch.Tensor]:
    """Shared normalization + concatenated folded projections for all
    branches; the per-branch (N, L, H) activations."""
    dtype = tower_dtype(model.config)
    ws, bs = zip(*(_fold_input_proj(getattr(br, proj_name), dtype)
                   for br in model.branches))
    xn = _ln_normalize_f32(feat).to(dtype)
    y = torch.relu(xn @ torch.cat(ws, 1).to(feat.device)
                   + torch.cat(bs).to(feat.device))
    return list(y.split([w.shape[1] for w in ws], dim=-1))


@torch.no_grad()
def encode_context_fast(model, feat: torch.Tensor, mask: torch.Tensor
                        ) -> Pair:
    """== model.encode_context(feat, mask) in eval mode."""
    outs = []
    for br, x in zip(model.branches,
                     _fused_projection(model, feat, "visual_input_proj")):
        pe = br.visual_pos_embed
        pos = pe.position_embeddings.weight[: x.shape[1]].to(x.dtype)
        x = _ln(x + pos[None], pe.LayerNorm)
        x = _attention(x, mask, br.visual_encoder, model.config.n_heads)
        om = br.out_mapping_linear
        outs.append(x @ om.weight.T.to(x.dtype) + om.bias.to(x.dtype))
    return outs[0], (outs[1] if len(outs) > 1 else None)


def _pos_rows_grid(pos: torch.Tensor, l: int) -> torch.Tensor:
    """Positional rows for length l with the 8-token grid allowance: up to
    the 8-rounded table size, tail positions get zero rows (and must be
    masked)."""
    if l > -(-pos.shape[0] // 8) * 8:
        raise ValueError(
            f"sequence length {l} exceeds the learned positional table "
            f"({pos.shape[0]}) — the model would fail here too")
    if l > pos.shape[0]:
        pos = torch.nn.functional.pad(pos, (0, 0, 0, l - pos.shape[0]))
    return pos[:l]


@torch.no_grad()
def encode_query_fast(model, feat: torch.Tensor, mask: torch.Tensor
                      ) -> Pair:
    """== model.encode_query(feat, mask) in eval mode, accepting
    grid-packed token buffers (positions past the table are padding)."""
    xs = _fused_projection(model, feat, "query_input_proj")
    n_pos = min(br.query_pos_embed.position_embeddings.weight.shape[0]
                for br in model.branches)
    if feat.shape[1] > n_pos:
        keep = (torch.arange(feat.shape[1], device=mask.device) < n_pos)
        mask = mask * keep.to(mask.dtype)[None, :]
    outs = []
    for br, x in zip(model.branches, xs):
        pe = br.query_pos_embed
        pos = _pos_rows_grid(pe.position_embeddings.weight,
                             x.shape[1]).to(x.dtype)
        x = _ln(x + pos[None], pe.LayerNorm)
        x = _attention(x, mask, br.query_encoder, model.config.n_heads)
        att = x @ br.modular_vector_mapping.weight.T.to(x.dtype)
        att = torch.softmax(mask_logits(att, mask[:, :, None].to(att.dtype)),
                            dim=1)
        outs.append((att * x).sum(dim=1))
    return outs[0], (outs[1] if len(outs) > 1 else None)


def _launch_groups(model) -> List[List[int]]:
    """Branch indices of each tower launch: both branches in one launch
    when they share a hidden size, else one launch per branch."""
    c = model.config
    n = len(model.branches)
    if n == 2 and c.inheritance_hidden == c.exploration_hidden:
        return [[0, 1]]
    return [[i] for i in range(n)]


@traced("eval/pack_weights")
def tower_weights(model, device=None) -> Dict[str, list]:
    """Every branch's query and video weight tuples in the config's tower
    dtype, on `device`, and under "packed" each launch's operands in the
    kernels' layout (`pack_weights`, per tower kind, one entry per launch
    group): made once per eval or Retriever model instead of once per
    batch."""
    dtype = tower_dtype(model.config)

    def move(ws):
        return tuple(w.to(device) if device is not None else w for w in ws)

    ws = {"query": [move(weights_for_branch(model, n, dtype))
                    for n in model.branch_names],
          "context": [move(context_weights_for_branch(model, n, dtype))
                      for n in model.branch_names]}
    ws["packed"] = {kind: [pack_weights([ws[kind][i] for i in group], dtype,
                                        model.config.n_heads, device)
                           for group in _launch_groups(model)]
                    for kind in ("query", "context")}
    return ws


def _pair(outs: List[torch.Tensor]) -> Pair:
    return outs[0], (outs[1] if len(outs) > 1 else None)


def _context(model, feat, mask, weights, plain, emit_q8) -> Pair:
    ws = weights or tower_weights(model, feat.device)
    dtype = tower_dtype(model.config)
    groups = _launch_groups(model)
    what = "fused_context_tower" + ("_dual" if len(groups[0]) == 2 else "")
    outs = []
    for group, packed in zip(groups, ws["packed"]["context"]):
        outs += context_towers(feat, mask, [ws["context"][i] for i in group],
                               model.config.n_heads, dtype, what, plain,
                               emit_q8, packed)
    return _pair(outs)


@torch.no_grad()
def encode_context_best(model, feat: torch.Tensor, mask: torch.Tensor,
                        weights: Optional[Dict[str, list]] = None,
                        plain: bool = False) -> Pair:
    """Frame features per branch, (Nv, L, H) in the tower dtype: the
    two-branch kernel launch when the branches share a hidden size, else
    one one-branch launch per branch."""
    return _context(model, feat, mask, weights, plain, emit_q8=False)


@torch.no_grad()
def encode_context_q8(model, feat: torch.Tensor, mask: torch.Tensor,
                      weights: Optional[Dict[str, list]] = None,
                      plain: bool = False) -> Pair:
    """int8 index rows per branch, (Nv, L, H) int8: `quantize_frames_q8`
    of the frame features that encode_context_best returns, computed by
    the towers' int8 epilogue (emit_q8) so the frames in the tower dtype
    never leave the launch (dldkd_tpu/ops/fast_eval.py:161-201)."""
    return _context(model, feat, mask, weights, plain, emit_q8=True)


@torch.no_grad()
def encode_query_best(model, feat: torch.Tensor, mask: torch.Tensor,
                      weights: Optional[Dict[str, list]] = None,
                      plain: bool = False) -> Pair:
    """Pooled query vectors per branch, (Nq, H): f32, cast to bf16 in a
    bf16 config (dldkd_tpu/ops/fast_eval.py:247-251)."""
    ws = weights or tower_weights(model, feat.device)
    dtype = tower_dtype(model.config)
    groups = _launch_groups(model)
    what = "fused_query_tower" + ("_dual" if len(groups[0]) == 2 else "")
    # the smallest table across branches: every branch sees the same tail
    # mask (fast_eval.py:237-246)
    n_pos = min(w[2].shape[0] for w in ws["query"])
    outs = []
    for group, packed in zip(groups, ws["packed"]["query"]):
        outs += query_towers(feat, mask, [ws["query"][i] for i in group],
                             model.config.n_heads, dtype, n_pos, what, plain,
                             packed)
    if dtype == torch.bfloat16:
        outs = [o.to(torch.bfloat16) for o in outs]
    return _pair(outs)
