"""The DL-DKD++ student in plain PyTorch: the yardstick the benchmark holds
the program's outputs against.

Written from the published model (HuiGuanLab/DL-DKD, method/model.py):
per branch ("" inheritance, "exp_" exploration) a query tower (LayerNorm
-> dropout -> Linear -> ReLU, learned positions + LayerNorm + dropout, one
BERT self-attention block with a residual LayerNorm, a learned 1-d
attention pooling) and a video tower (the same without the pooling, plus
an output Linear). Parameters are a flat dict under the reference's
state-dict names, so the benchmark can make one set of weights and hand
the same tensors to the program and to this module. Nothing here imports
the program, JAX or a kernel; every product is a plain torch call, and
`exact_f32` turns TF32 off around the caller's block.

Dropout draws its keep masks from the caller's `torch.Generator`
(uniform float32 draws of the activation's shape, kept where >= p), in
the order of the forward below, so a training step that follows the same
order sees the same masks. `gen=None` is eval mode.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e10      # the reference's masked-logit sentinel (model.py:444)
LN_EPS = 1e-5
ATTN_MASK = -10000.0  # BERT's additive key mask
PREFIXES = {"inheritance": "", "exploration": "exp_"}

Params = Dict[str, torch.Tensor]


@contextlib.contextmanager
def exact_f32(on: bool = True):
    """float32 products without TF32 (on=True) or with it (on=False, the
    control's lower precision) for the duration of the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = not on
    torch.backends.cudnn.allow_tf32 = not on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def branches(cfg: dict) -> List[str]:
    return ["inheritance"] + (["exploration"] if cfg["double_branch"]
                              else [])


def param_spec(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every parameter; init is "normal" (N(0,
    initializer_range)), "zeros" or "ones", the reference's init
    (model.py:80-93)."""
    spec: List[Tuple[str, Tuple[int, ...], str]] = []

    def ln(name, d):
        spec.extend([(f"{name}.weight", (d,), "ones"),
                     (f"{name}.bias", (d,), "zeros")])

    def lin(name, d_out, d_in, bias=True):
        spec.append((f"{name}.weight", (d_out, d_in), "normal"))
        if bias:
            spec.append((f"{name}.bias", (d_out,), "zeros"))

    def attention(name, h):
        for part in ("query", "key", "value"):
            lin(f"{name}.self.{part}", h, h)
        lin(f"{name}.output.dense", h, h)
        ln(f"{name}.output.LayerNorm", h)

    for br in branches(cfg):
        p = PREFIXES[br]
        h = cfg[f"{br}_hidden"]
        ln(f"{p}query_input_proj.LayerNorm", cfg["query_input_size"])
        lin(f"{p}query_input_proj.net.1", h, cfg["query_input_size"])
        spec.append((f"{p}query_pos_embed.position_embeddings.weight",
                     (cfg["max_desc_l"], h), "normal"))
        ln(f"{p}query_pos_embed.LayerNorm", h)
        attention(f"{p}query_encoder", h)
        lin(f"{p}modular_vector_mapping", 1, h, bias=False)
        ln(f"{p}visual_input_proj.LayerNorm", cfg["visual_input_size"])
        lin(f"{p}visual_input_proj.net.1", h, cfg["visual_input_size"])
        spec.append((f"{p}visual_pos_embed.position_embeddings.weight",
                     (cfg["max_ctx_l"], h), "normal"))
        ln(f"{p}visual_pos_embed.LayerNorm", h)
        attention(f"{p}visual_encoder", h)
        lin(f"{p}out_mapping_linear", h, h)
    return spec


def dropout(x: torch.Tensor, p: float, gen: Optional[torch.Generator]
            ) -> torch.Tensor:
    if gen is None or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device,
                      dtype=torch.float32) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def layer_norm(x: torch.Tensor, P: Params, name: str) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], P[f"{name}.weight"],
                        P[f"{name}.bias"], LN_EPS)


def linear(x: torch.Tensor, P: Params, name: str) -> torch.Tensor:
    return F.linear(x, P[f"{name}.weight"], P.get(f"{name}.bias"))


def mask_logits(target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return target * mask + (1.0 - mask) * NEG_INF


def input_proj(x, P, name, p, gen):
    x = dropout(layer_norm(x, P, f"{name}.LayerNorm"), p, gen)
    return torch.relu(linear(x, P, f"{name}.net.1"))


def pos_embed(x, P, name, p, gen):
    pos = P[f"{name}.position_embeddings.weight"][: x.shape[1]]
    return dropout(layer_norm(x + pos[None], P, f"{name}.LayerNorm"), p,
                   gen)


def attention(x, mask, P, name, n_heads, p, gen):
    b, l, h = x.shape
    d = h // n_heads

    def heads(part):
        return linear(x, P, f"{name}.self.{part}").reshape(
            b, l, n_heads, d).transpose(1, 2)

    q, k, v = heads("query"), heads("key"), heads("value")
    scores = q @ k.transpose(-1, -2) / math.sqrt(d)
    scores = scores + (1.0 - mask[:, None, None, :]) * ATTN_MASK
    probs = dropout(torch.softmax(scores, dim=-1), p, gen)
    ctx = (probs @ v).transpose(1, 2).reshape(b, l, h)
    out = dropout(linear(ctx, P, f"{name}.output.dense"), p, gen)
    return layer_norm(out + x, P, f"{name}.output.LayerNorm")


def encode_query(P: Params, cfg: dict, branch: str, feat, mask,
                 gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """(N, Lq, Dq), (N, Lq) -> pooled (N, H)."""
    pre = PREFIXES[branch]
    x = input_proj(feat, P, f"{pre}query_input_proj", cfg["input_drop"],
                   gen)
    x = pos_embed(x, P, f"{pre}query_pos_embed", cfg["input_drop"], gen)
    x = attention(x, mask, P, f"{pre}query_encoder", cfg["n_heads"],
                  cfg["drop"], gen)
    att = linear(x, P, f"{pre}modular_vector_mapping")
    att = torch.softmax(mask_logits(att, mask[:, :, None]), dim=1)
    return (att * x).sum(dim=1)


def encode_context(P: Params, cfg: dict, branch: str, feat, mask,
                   gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """(N, L, Dv), (N, L) -> frame features (N, L, H)."""
    pre = PREFIXES[branch]
    x = input_proj(feat, P, f"{pre}visual_input_proj", cfg["input_drop"],
                   gen)
    x = pos_embed(x, P, f"{pre}visual_pos_embed", cfg["input_drop"], gen)
    x = attention(x, mask, P, f"{pre}visual_encoder", cfg["n_heads"],
                  cfg["drop"], gen)
    return linear(x, P, f"{pre}out_mapping_linear")


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(norm, min=eps)


def clip_scores_max(query: torch.Tensor, frames: torch.Tensor,
                    mask: torch.Tensor, block: int = 256) -> torch.Tensor:
    """Masked-cosine clip scores (Nq, Nv): cosine of each pooled query with
    every frame, padded frames at -1e10, the max over frames; computed for
    `block` queries at a time (reference get_sim_scores, model.py:307)."""
    fn = l2_normalize(frames)
    nv, l, h = fn.shape
    flat = fn.reshape(nv * l, h).T
    bias = ((1.0 - mask) * NEG_INF).reshape(1, nv, l)
    keep = mask.reshape(1, nv, l)
    out = torch.empty((query.shape[0], nv), dtype=torch.float32,
                      device=query.device)
    for s in range(0, query.shape[0], block):
        q = l2_normalize(query[s:s + block])
        sim = (q @ flat).reshape(q.shape[0], nv, l)
        out[s:s + block] = (sim * keep + bias).amax(dim=2)
    return out
