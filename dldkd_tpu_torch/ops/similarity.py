"""Query-to-video frame similarity: the retrieval core (port of
dldkd_tpu/ops/similarity.py).

Semantics of the reference `get_sim_scores` (method/model.py:307-329):
per-frame cosine between a pooled query vector and every frame of every
video, padded frames masked to -1e10, then a max over frames gives the
clip-level score.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dldkd_tpu_torch.ops.kernels.sim_max import (fused_clip_scores,
                                                 sim_max_plain)
from dldkd_tpu_torch.ops.masking import l2_normalize, mask_logits


def frame_similarity(query: torch.Tensor,          # (Nq, D)
                     ctx: torch.Tensor,            # (Nv, L, D)
                     mask: Optional[torch.Tensor] = None,  # (Nv, L)
                     ) -> torch.Tensor:
    """The full per-frame cosine tensor, (Nq, L, Nv); masked frames are
    -1e10. Builds the whole tensor: for corpus-scale scoring use
    clip_scores_maxpool."""
    query = l2_normalize(query)
    ctx = l2_normalize(ctx)
    scores = torch.einsum("md,nld->mln", query, ctx)
    if mask is not None:
        scores = mask_logits(scores, mask.T[None].to(scores.dtype))
    return scores


def clip_scores(query: torch.Tensor, ctx: torch.Tensor,
                mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cosine clip scores (Nq, Nv) as the max over frames, plus the full
    (Nq, L, Nv) frame tensor (reference get_sim_scores)."""
    frame = frame_similarity(query, ctx, mask)
    return frame.amax(dim=1), frame


def clip_scores_maxpool(query: torch.Tensor,   # (Nq, D)
                        ctx: torch.Tensor,     # (Nv, L, D)
                        mask: Optional[torch.Tensor] = None,
                        ctx_normalized: bool = False,
                        plain: bool = False) -> torch.Tensor:
    """Cosine clip scores (Nq, Nv) f32 without the frame tensor.

    Both sides are L2-normalized here in their own dtype (the bf16 rounding
    of `l2_normalize`), unless `ctx_normalized` says the caller already
    normalized the frames (the eval normalizes its corpus once, not once
    per query batch). Mixed dtypes score in f32. A CUDA tensor goes to the
    CUDA kernel, a CPU tensor to its plain version; `plain=True` runs the
    plain version on any device (the reference side of a kernel check)."""
    nv, l_frames, _ = ctx.shape
    if mask is None:
        mask = torch.ones((nv, l_frames), dtype=torch.float32,
                          device=ctx.device)
    if query.dtype != ctx.dtype:
        query, ctx = query.float(), ctx.float()
    qn = l2_normalize(query).contiguous()
    cn = ctx if ctx_normalized else l2_normalize(ctx)
    cn = cn.contiguous()
    mask = mask.float().contiguous()
    if plain:
        return sim_max_plain(qn, cn, mask)
    return fused_clip_scores(qn, cn, mask)
