"""Query-to-video frame similarity: the retrieval core (port of
dldkd_tpu/ops/similarity.py).

Semantics of the reference `get_sim_scores` (method/model.py:307-329):
per-frame cosine between a pooled query vector and every frame of every
video, padded frames masked to -1e10, then a max over frames gives the
clip-level score. The int8 scorers, the stage-2 rescore helpers of
two-stage serving and its dense-versus-gather dispatch live here too.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional, Tuple

import torch

from dldkd_tpu_torch.ops.kernels.sim_max import (
    EXACT_MAX_DEPTH, INT8_MASK_BIAS, INV_SCALE2, fused_clip_scores,
    fused_clip_scores_int8, fused_clip_scores_q8, fused_exact_scores,
    q8_index_bias, quantize_unit_int8, sim_max_plain)
from dldkd_tpu_torch.ops.masking import l2_normalize, mask_logits


def frame_similarity(query: torch.Tensor,          # (Nq, D)
                     ctx: torch.Tensor,            # (Nv, L, D)
                     mask: Optional[torch.Tensor] = None,  # (Nv, L)
                     normalized: bool = True) -> torch.Tensor:
    """The full per-frame score tensor, (Nq, L, Nv): cosine, or raw dot
    products with normalized=False; masked frames are -1e10. Builds the
    whole tensor: for corpus-scale scoring use clip_scores_maxpool."""
    if normalized:
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
                        plain: bool = False,
                        quantized: bool = False) -> torch.Tensor:
    """Cosine clip scores (Nq, Nv) f32 without the frame tensor.

    Both sides are L2-normalized here in their own dtype (the bf16 rounding
    of `l2_normalize`), unless `ctx_normalized` says the caller already
    normalized the frames (the eval normalizes its corpus once, not once
    per query batch). Mixed dtypes score in f32. A CUDA tensor goes to the
    CUDA kernel, a CPU tensor to its plain version; `plain=True` runs the
    plain version on any device (the reference side of a kernel check).

    quantized=True scores int8 cosine components (scale 127; ~2.7e-3
    absolute score error) with the int8 kernel; masked frames then
    dequantize to NEG_BIG_INT8 (~-6.7e4) instead of -1e10, which ranks the
    same."""
    nv, l_frames, _ = ctx.shape
    if quantized:
        if mask is None:
            mask = torch.ones((nv, l_frames), device=ctx.device)
        cn = ctx if ctx_normalized else l2_normalize(ctx)
        return fused_clip_scores_int8(
            quantize_unit_int8(l2_normalize(query)).contiguous(),
            quantize_unit_int8(cn).contiguous(),
            q8_index_bias(mask).contiguous(), plain)
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


def clip_scores_maxpool_pre8(query: torch.Tensor,  # (Nq, D) float
                             ctx_q8: torch.Tensor,  # (Nv, L, D) int8 index
                             bias: torch.Tensor,    # (Nv, L) int32
                             plain: bool = False) -> torch.Tensor:
    """int8 cosine clip scores (Nq, Nv) against a prebuilt int8 index
    (`ops.kernels.sim_max.build_q8_index`): the corpus-sized normalize and
    quantize pass of clip_scores_maxpool(quantized=True) happens once at
    index build instead of per call. Scores are bitwise the quantized=True
    path's on the same quantized components."""
    return fused_clip_scores_q8(query, ctx_q8, bias, plain)


def _quantized_scores_plain(query: torch.Tensor, ctx: torch.Tensor,
                            mask: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """The int8 semantics in plain f32 arithmetic (twin of dldkd_tpu's
    `_quantized_scores_xla`): quantized components are integers, their
    products and sums stay below 2^24, so f32 is exact on valid frames.
    Builds the whole (Nq, L, Nv) tensor: small inputs only."""
    qn = quantize_unit_int8(l2_normalize(query)).float()
    cn = quantize_unit_int8(l2_normalize(ctx)).float()
    s = torch.einsum("md,nld->mln", qn, cn)
    if mask is not None:
        bias = torch.where(mask > 0, 0.0, float(INT8_MASK_BIAS))
        s = s + bias.T[None]
    return s.amax(dim=1) * INV_SCALE2


@contextlib.contextmanager
def _true_f32_matmul():
    """f32 matmuls in full f32 on the card for the duration (no TF32),
    whatever the process set."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def rescore_shortlist(query: torch.Tensor,     # (Nq, D)
                      ctx: torch.Tensor,       # (Nv, L, D)
                      mask: torch.Tensor,      # (Nv, L)
                      cand_idx: torch.Tensor,  # (Nq, K') candidate ids
                      chunk: int = 16) -> torch.Tensor:
    """Exact f32 cosine max-over-frames scores (Nq, K') of per-query
    candidate shortlists: stage 2 of two-stage retrieval. The candidate
    frames are gathered in their stored dtype in chunks of `chunk` queries
    (transient memory chunk x K' x L x D), widened to f32 and normalized
    after the gather (the same f32 values as gathering from a normalized
    corpus), dotted in true f32 (no TF32 whatever the inputs' dtype or the
    process' setting), masked to -1e10 and maxed over frames. Plain
    PyTorch on every device, as the JAX package runs it in XLA."""
    nq = query.shape[0]
    qn = l2_normalize(query.float())
    out = torch.empty(cand_idx.shape, dtype=torch.float32,
                      device=query.device)
    with _true_f32_matmul():
        for s in range(0, nq, chunk):
            idx = cand_idx[s:s + chunk]
            frames = l2_normalize(ctx[idx].float())     # (C, K', L, D)
            fmask = mask[idx].float()                    # (C, K', L)
            c, k, l_frames, d = frames.shape
            sc = torch.bmm(frames.reshape(c, k * l_frames, d),
                           qn[s:s + chunk, :, None]).reshape(c, k, l_frames)
            out[s:s + chunk] = mask_logits(sc, fmask).amax(dim=-1)
    return out


def exact_clip_scores(query: torch.Tensor,   # (Nq, D)
                      ctx: torch.Tensor,     # (Nv, L, D) bf16 or f32
                      mask: torch.Tensor,    # (Nv, L)
                      plain: bool = False) -> torch.Tensor:
    """Exact-grade f32 cosine max-over-frames scores for all videos,
    (Nq, Nv): the dense twin of rescore_shortlist, with the whole corpus as
    the shortlist. bf16-stored frames take the exact-rescore kernel
    (`fused_exact_scores`: f32 query against the raw bf16 frames, scaled
    by the reciprocal frame norm after the dot); f32-stored frames take the
    f32 masked-cosine kernel, which computes exactly the JAX package's
    fallback there (clip_scores at HIGHEST precision) without building the
    (Nq, L, Nv) tensor. The two routes differ by ~1 f32 ulp per score."""
    if ctx.dtype == torch.bfloat16:
        return fused_exact_scores(query, ctx, mask.float().contiguous(),
                                  plain)
    return clip_scores_maxpool(query.float(), ctx.float(), mask, plain=plain)


# The dense-versus-gather cost model of stage 2, in the port's own
# constants, measured by chip_smoke.py (phase 3, its "dense_rescore"
# record) on an NVIDIA H100 80GB HBM3 at a 700 W power limit, at TVR
# serving shapes (frames 2179 x 128 x 384, 256 queries, K' = 40); rounded
# to three digits:
# - the candidate gather of rescore_shortlist: 6.05 ms, i.e. 166 GB/s of
#   gathered bf16 frames;
# - the exact kernel (bf16 frames; split-3 bf16 products on the tensor
#   cores): 0.372 ms, 148 T multiply-add operations (2 per product of the
#   f32 query, counted once) per second; the f32 masked-cosine kernel (f32
#   frames; 3xTF32): 0.822 ms, 66.7 T/s;
# - the dense route's per-call pass over the stored frames: the frame
#   scales of bf16 frames, 0.138 ms (1.56 TB/s of frames read); the
#   normalization of f32 frames, 0.517 ms (0.829 TB/s).
_GATHER_BYTES_PER_S = 166e9
_DENSE_FLOPS_BF16 = 148e12
_DENSE_FLOPS_F32 = 66.7e12
_DENSE_BYTES_PER_S_BF16 = 1.56e12
_DENSE_BYTES_PER_S_F32 = 0.829e12


def dense_rescore_mode() -> str:
    """The DLDKD_DENSE_RESCORE mode: 'auto' (the cost model decides),
    'never' or 'always'. A value outside those raises: the knob exists to
    override a mispredicting model, so a typo must not fall back to it."""
    mode = os.environ.get("DLDKD_DENSE_RESCORE", "auto").strip().lower()
    if mode in ("never", "0", "false"):
        return "never"
    if mode in ("always", "1", "true"):
        return "always"
    if mode in ("", "auto"):
        return "auto"
    raise ValueError(f"DLDKD_DENSE_RESCORE={mode!r}: use auto|never|always")


def dense_rescore_wins(nq: int, k_short: int, nv: int, l_frames: int,
                       d: int, itemsize: int) -> bool:
    """Should stage 2 score the whole corpus exactly (dense) instead of
    gathering each query's candidate frames? Both give exact-f32-grade
    scores, so this is a speed choice, read from the shapes with the
    constants above; the dense side also never misses a true top-k video
    that stage 1 left out. DLDKD_DENSE_RESCORE=never|always pins it
    (`dense_rescore_mode`); it is read at every call."""
    mode = dense_rescore_mode()
    if mode == "never":
        return False
    if mode == "always":
        return True
    if itemsize <= 2 and d > EXACT_MAX_DEPTH:   # the exact kernel's limit
        return False
    flops, rate = ((_DENSE_FLOPS_BF16, _DENSE_BYTES_PER_S_BF16)
                   if itemsize <= 2 else
                   (_DENSE_FLOPS_F32, _DENSE_BYTES_PER_S_F32))
    gather_t = nq * k_short * l_frames * d * itemsize / _GATHER_BYTES_PER_S
    dense_t = (2.0 * nq * nv * l_frames * d / flops
               + nv * l_frames * d * itemsize / rate)
    return dense_t < gather_t


def clip_scores_unnormalized(query: torch.Tensor, ctx: torch.Tensor,
                             mask: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Raw-dot clip scores (Nq, Nv) (reference get_unnormalized_sim_scores,
    model.py:331-350). Builds the whole frame tensor: small inputs only."""
    return frame_similarity(query, ctx, mask, normalized=False).amax(dim=1)
