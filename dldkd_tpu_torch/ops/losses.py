"""Retrieval and distillation losses (port of dldkd_tpu/ops/losses.py):
those of the training step, and the reference's ablation losses
(`clip_mse` .. `batch_kl_loss`, losses.py:251-410 there), which the
shipped training path does not call.

The same masked tensor math as the JAX package, in PyTorch autograd. Batch
convention (static shapes; see data/pipeline.py):
  scores:  (Nq, Nv) query-to-video clip scores; Nq is the PADDED query axis
  labels:  (Nq,) int, video index within the batch per query, -1 = padding;
  valid queries form a prefix, in the sorted batch order that the soft-NCE
  alpha-partition depends on.

Where JAX and PyTorch would differ at ties, this module takes JAX's rule:
maxima through `amax`/`maximum`, which split the gradient evenly among
ties; the hard-negative ranking through a stable descending sort, which
breaks ties by the lowest index as `jax.lax.top_k` does. Negatives are
drawn from the caller's `torch.Generator`: the same distributions as the
JAX package's key streams (which torch cannot reproduce), not the same
draws. The ablations keep the JAX versions' `valid` masks (padded rows
drop out of sums and means; the reference never pads, so `valid=None` is
the reference's math) and their zero-length rules (a mean over no valid
row or frame divides by 1).
"""

from __future__ import annotations

from typing import Optional

import torch

from dldkd_tpu_torch.ops.masking import NEG_INF

Tensor = torch.Tensor


def _zero(x: Tensor) -> Tensor:
    return torch.zeros((), dtype=x.dtype, device=x.device)


def _one_hot_labels(labels: Tensor, n_videos: int) -> Tensor:
    """(Nq, Nv) ground-truth matrix I_ij; zero rows for padded queries.
    Reference: label_dict -> I_ij (model_components.py:137-141)."""
    valid = labels >= 0
    oh = torch.nn.functional.one_hot(
        torch.where(valid, labels, 0).long(), n_videos).float()
    return oh * valid[:, None].float()


def _masked_logsumexp(x: Tensor, mask: Tensor, dim: int) -> Tensor:
    """logsumexp over `dim` counting only mask==True positions."""
    return torch.logsumexp(torch.where(mask, x, NEG_INF), dim=dim)


def _uniform_choice(generator: torch.Generator, mask: Tensor,
                    values: Tensor) -> Tensor:
    """One element of `values` per row, uniform over the mask==True
    positions of the last axis: Gumbel-max over equal logits (reference
    randint-into-index-set sampling, model.py:366-368, 376-383)."""
    u = torch.rand(values.shape, generator=generator, device=values.device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log(-torch.log(u.clamp(min=tiny)))
    g = torch.where(mask, g, NEG_INF)
    idx = torch.argmax(g, dim=-1)
    return torch.gather(values, -1, idx[..., None])[..., 0]


def clip_triplet_loss(scores: Tensor, labels: Tensor,
                      generator: torch.Generator, margin: float,
                      use_hard_negative: bool, hard_pool_size: int) -> Tensor:
    """Bidirectional hinge loss; reference get_clip_triplet_loss
    (model.py:353-387).

    v2t: per video, hinge(margin + neg - mean_of_positive_caption_scores);
         neg = top-1 negative caption when hard, else uniform negative.
    t2v: per query, hinge(margin + neg - score[q, label]); neg sampled
         uniformly from ranks [1, 1+hard_pool_size) of the positive-masked
         descending sort when hard, else uniformly over all non-positives.
    Normalization: t2v summed / n_valid_queries + v2t summed / n_videos.
    """
    nq, nv = scores.shape
    valid_f = (labels >= 0).float()
    n_valid = torch.clamp(valid_f.sum(), min=1.0)
    oh = _one_hot_labels(labels, nv)
    zero = _zero(scores)

    # ---- v2t: rows are videos, columns are captions
    v2t = scores.T
    neg_mask = ((1.0 - oh.T) * valid_f[None, :]) > 0
    pos_cnt = torch.clamp(oh.T.sum(dim=1), min=1.0)
    pos_mean = (v2t * oh.T).sum(dim=1) / pos_cnt
    if use_hard_negative:
        neg = torch.where(neg_mask, v2t, NEG_INF).amax(dim=1)
    else:
        neg = _uniform_choice(generator, neg_mask, v2t)
    v2t_loss = torch.maximum(margin + neg - pos_mean, zero).sum()

    # ---- t2v: rows are queries
    pos = (scores * oh).sum(dim=1)
    if use_hard_negative:
        # the positive, masked to 999, ranks first; a rank uniform in
        # [1, min(1 + pool, Nv)) of the descending sort (model.py:374-383)
        masked = torch.where(oh > 0, 999.0, scores)
        k = min(1 + hard_pool_size, nv)
        top_vals = torch.sort(masked, dim=1, descending=True,
                              stable=True).values[:, :k]
        if k < 2:
            # a one-video batch has no rank 1: JAX's gather out of range
            # gives NaN there, and no gradient
            neg_t = torch.full_like(pos, float("nan"))
            pos = pos.detach()
        else:
            ranks = torch.randint(1, k, (nq,), generator=generator,
                                  device=scores.device)
            neg_t = torch.gather(top_vals, 1, ranks[:, None])[:, 0]
    else:
        neg_t = _uniform_choice(generator, oh <= 0, scores)
    t2v_loss = torch.maximum(margin + neg_t - pos, zero) * valid_f
    return t2v_loss.sum() / n_valid + v2t_loss / nv


def clip_nce(scores: Tensor, labels: Tensor) -> Tensor:
    """Hard-label InfoNCE; reference clip_nce (model_components.py:211-236).

    t2v: mean over queries of logsumexp(row) - score[q, label].
    v2t: mean over videos of logsumexp(all queries) - logsumexp(own captions).
    """
    nq, nv = scores.shape
    valid_q = labels >= 0
    valid_f = valid_q.float()
    n_valid = torch.clamp(valid_f.sum(), min=1.0)
    oh = _one_hot_labels(labels, nv)

    t2v_nom = (scores * oh).sum(dim=1)
    t2v_den = torch.logsumexp(scores, dim=1)
    t2v = ((t2v_den - t2v_nom) * valid_f).sum() / n_valid

    v2t_nom = _masked_logsumexp(scores, oh > 0, dim=0)
    v2t_den = _masked_logsumexp(scores, valid_q[:, None].expand(nq, nv),
                                dim=0)
    return t2v + (v2t_den - v2t_nom).mean()


def hard_count(alpha: Tensor, n) -> Tensor:
    """The soft-NCE partition, floor(alpha * n), with the product in
    float32 (alpha a float32 tensor, n an integer tensor or int), as the
    JAX package computes it (losses.py:161-164): in float64 the floor
    differs at some schedule values (alpha 0.19999999999999996, n 5)."""
    return torch.floor(alpha * n).long()


def clip_nce_soft(scores: Tensor, sims: Tensor, labels: Tensor,
                  alpha: Tensor, belta: Tensor) -> Tensor:
    """Soft-label NCE / self-distillation; reference clip_nce_soft
    (model_components.py:106-209).

    Rows 0..hardQ-1 (by position in the sorted batch) use pure GT targets;
    the remaining valid rows use clamp((1-beta)*softmax(sims) + beta*GT, 0).
    Same split over the video axis for v2t. Final:
    alpha*hard_part + (1-alpha)*soft_part, each part mean-normalized.
    alpha and belta are float32 scalars: hardQ = floor(alpha * n_valid) in
    float32, as the JAX package splits. The gradient flows through the
    soft target too (no detach: the exploration branch passes its own
    scores as `sims`).
    """
    nq, nv = scores.shape
    dev = scores.device
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    belta = torch.as_tensor(belta, dtype=torch.float32, device=dev)
    valid_q = labels >= 0
    n_valid = valid_q.sum()
    q_idx = torch.arange(nq, device=dev)
    v_idx = torch.arange(nv, device=dev)
    zero = _zero(scores)

    hard_q = hard_count(alpha, n_valid)
    soft_q = n_valid - hard_q
    hard_v = hard_count(alpha, nv)
    soft_v = nv - hard_v

    is_hard_q = (q_idx < hard_q) & valid_q
    is_soft_q = (q_idx >= hard_q) & valid_q
    is_hard_v = v_idx < hard_v
    is_soft_v = v_idx >= hard_v

    oh = _one_hot_labels(labels, nv)

    # -- t2v targets: soft rows mix in softmax over videos
    sims_t = torch.softmax(sims, dim=-1)
    i_q = torch.where(is_soft_q[:, None],
                      torch.maximum((1.0 - belta) * sims_t + belta * oh,
                                    zero),
                      oh)
    row_lse = torch.logsumexp(scores, dim=1)
    t2v_nom = (i_q * scores).sum(dim=1)
    t2v_den = i_q.sum(dim=1) * row_lse
    t2v_hard = ((t2v_den - t2v_nom) * is_hard_q.float()).sum()
    t2v_soft = ((t2v_den - t2v_nom) * is_soft_q.float()).sum()

    # -- v2t targets: soft rows mix in softmax over (valid) queries
    sims_v = torch.softmax(torch.where(valid_q[None, :], sims.T, NEG_INF),
                           dim=-1)
    i_v = torch.where(is_soft_v[:, None],
                      torch.maximum((1.0 - belta) * sims_v + belta * oh.T,
                                    zero),
                      oh.T)
    # logsumexp(log(I_V + 1e-12) + scores[:, i]) over valid queries
    col_mask = valid_q[None, :].expand(nv, nq)
    v2t_nom = _masked_logsumexp(torch.log(i_v + 1e-12) + scores.T,
                                col_mask, dim=1)
    v2t_den = _masked_logsumexp(scores.T, col_mask, dim=1)
    v2t_hard = ((v2t_den - v2t_nom) * is_hard_v.float()).sum()
    v2t_soft = ((v2t_den - v2t_nom) * is_soft_v.float()).sum()

    hard_ok = (hard_q > 0) & (hard_v > 0)
    soft_ok = (soft_q > 0) & (soft_v > 0)
    hard_loss = torch.where(
        hard_ok,
        t2v_hard / torch.clamp(hard_q, min=1)
        + v2t_hard / torch.clamp(hard_v, min=1), zero)
    soft_loss = torch.where(
        soft_ok,
        t2v_soft / torch.clamp(soft_q, min=1)
        + v2t_soft / torch.clamp(soft_v, min=1), zero)
    return alpha * hard_loss + (1.0 - alpha) * soft_loss


def frame_kl_loss(student_frame: Tensor, teacher_frame: Tensor,
                  video_mask: Tensor, labels: Tensor,
                  temperature: float = 0.2) -> Tensor:
    """Per-positive-pair frame-level KL distillation; reference
    compute_kl_loss(mode='frame_score') (model.py:183-197) /
    clip_kl_only_pos (model_components.py:85-103).

    student_frame, teacher_frame: (Nq, L, Nv) masked cosine frame scores;
    video_mask (Nv, L). For each query, softmax(T=temperature) over the
    positive video's valid frames of student and teacher scores;
    KL(teacher || student) summed over frames, SUMMED over queries (the
    reference does not average).
    """
    nq, l_frames, _ = student_frame.shape
    valid_q = labels >= 0
    safe = torch.where(valid_q, labels, 0).long()
    idx = safe[:, None, None].expand(nq, l_frames, 1)
    p = torch.gather(student_frame, 2, idx)[..., 0]
    t = torch.gather(teacher_frame, 2, idx)[..., 0]
    fmask = video_mask[safe] > 0

    def masked_log_softmax(x):
        z = torch.where(fmask, x / temperature, NEG_INF)
        return z - torch.logsumexp(z, dim=-1, keepdim=True)

    log_p = masked_log_softmax(p)
    log_t = masked_log_softmax(t)
    # t*(log t - log p), with 0*log0 := 0 at masked frames
    contrib = torch.where(fmask, torch.exp(log_t) * (log_t - log_p),
                          _zero(log_t))
    return (contrib.sum(dim=-1) * valid_q.float()).sum()


def clip_mse(x: Tensor, target: Tensor,
             valid: Optional[Tensor] = None) -> Tensor:
    """Plain MSE distillation (ablation); reference clip_mse
    (model_components.py:28-38): squared diff summed over the frame axis
    (3-D input) or the last axis (2-D), then meaned. `valid` (bool, first
    axis) excludes padded rows from the mean."""
    d = torch.square(x - target)
    d = d.sum(dim=1 if d.dim() == 3 else -1)
    if valid is None:
        return d.mean()
    vf = valid.to(d.dtype)
    w = vf.reshape((-1,) + (1,) * (d.dim() - 1))
    per_row = d.numel() // d.shape[0]
    return (d * w).sum() / (torch.clamp(vf.sum(), min=1.0) * per_row)


def _pos_frames(frame_x: Tensor, frame_t: Tensor, video_mask: Tensor,
                labels: Tensor):
    """Each query's positive-video frame vectors, (Nq, L) twice, with the
    valid-frame and valid-query masks."""
    nq, l_frames, _ = frame_x.shape
    valid_q = labels >= 0
    safe = torch.where(valid_q, labels, 0).long()
    idx = safe[:, None, None].expand(nq, l_frames, 1)
    p = torch.gather(frame_x, 2, idx)[..., 0]
    q = torch.gather(frame_t, 2, idx)[..., 0]
    return p, q, video_mask[safe] > 0, valid_q


def clip_mse_pos_pair(frame_x: Tensor, frame_t: Tensor, video_mask: Tensor,
                      labels: Tensor) -> Tensor:
    """Frame-MSE on positive pairs (ablation); reference clip_mse_pos_pair
    (model_components.py:40-52): per query, mean over the positive video's
    valid frames of squared frame-score diffs, summed over queries."""
    p, q, fmask, valid_q = _pos_frames(frame_x, frame_t, video_mask, labels)
    d = torch.where(fmask, torch.square(p - q), _zero(p))
    m = torch.clamp(fmask.sum(dim=-1), min=1)
    return (d.sum(dim=-1) / m * valid_q.float()).sum()


def clip_mse_max_pos_pair(scores_x: Tensor, scores_t: Tensor,
                          labels: Tensor) -> Tensor:
    """Clip-score MSE at the positive (ablation); reference
    clip_mse_max_pos_pair (model_components.py:54-67): squared diff of the
    max-pooled clip scores at each query's positive video, meaned over the
    valid queries."""
    valid_q = labels >= 0
    safe = torch.where(valid_q, labels, 0).long()[:, None]
    p = torch.gather(scores_x, 1, safe)[:, 0]
    q = torch.gather(scores_t, 1, safe)[:, 0]
    d = torch.square(p - q) * valid_q.float()
    return d.sum() / torch.clamp(valid_q.sum(), min=1)


def clip_mse_only_pos_max(frame_x: Tensor, frame_t: Tensor,
                          video_mask: Tensor, labels: Tensor) -> Tensor:
    """MSE at the teacher's best frame (ablation); reference
    clip_mse_only_pos_max (model_components.py:69-83): per query, the
    valid frame where the teacher score peaks (the first at ties), squared
    diff there, summed."""
    p, q, fmask, valid_q = _pos_frames(frame_x, frame_t, video_mask, labels)
    best = torch.argmax(torch.where(fmask, q, NEG_INF), dim=-1)[:, None]
    d = torch.gather(p, 1, best)[:, 0] - torch.gather(q, 1, best)[:, 0]
    return (torch.square(d) * valid_q.float()).sum()


def frame_nce(scores: Tensor, reduction: bool = True,
              valid: Optional[Tensor] = None) -> Tensor:
    """Frame-level NCE (ablation); reference frame_nce
    (model_components.py:238-265). scores: (B, B, F) per-frame
    query-to-video scores for a square batch.
      nominator_i   = logsumexp over frames of the diagonal block i
      denominator_i = logsumexp over row i AND column i (both directions)
    `valid` (bool (B,)) excludes padded rows and columns.
    """
    b = scores.shape[0]
    x = scores.reshape(b, b, -1)
    idx = torch.arange(b, device=scores.device)
    nom = torch.logsumexp(x[idx, idx, :], dim=1)
    den_in = torch.cat([x, x.permute(1, 0, 2)], dim=1)
    if valid is not None:
        ok = torch.cat([valid, valid]).bool()
        den_in = torch.where(ok[None, :, None], den_in, NEG_INF)
    out = torch.logsumexp(den_in.reshape(b, -1), dim=1) - nom
    if valid is None:
        return out.mean() if reduction else out
    vf = valid.to(out.dtype)
    out = out * vf
    return out.sum() / torch.clamp(vf.sum(), min=1.0) if reduction else out


def ranking_loss(pos_score: Tensor, neg_score: Tensor,
                 margin: float) -> Tensor:
    """Mean hinge; reference get_ranking_loss (model.py:434-442)."""
    return (torch.maximum(margin + neg_score - pos_score,
                          _zero(pos_score)).sum() / pos_score.shape[0])


def sample_neg_scores(scores: Tensor, scores_masked: Tensor,
                      generator: torch.Generator, use_hard_negative: bool,
                      hard_pool_size: int) -> Tensor:
    """Per row, a negative score drawn uniformly from ranks [1, max_idx)
    of the descending sort of `scores_masked` (positives pre-masked to 999
    so they rank first and get skipped); reference get_neg_scores
    (model.py:412-432). max_idx = min(1 + pool, N) when hard, else N.
    With N = 1 there is no rank 1: the row's negative is NaN, as JAX's
    out-of-range gather gives."""
    n_rows, n = scores.shape
    k = min(1 + hard_pool_size, n) if use_hard_negative else n
    if k < 2:
        return torch.full((n_rows,), float("nan"), dtype=scores.dtype,
                          device=scores.device)
    idx = torch.sort(scores_masked, dim=1, descending=True,
                     stable=True).indices[:, :k]
    ranks = torch.randint(1, k, (n_rows,), generator=generator,
                          device=scores.device)
    cols = torch.gather(idx, 1, ranks[:, None])
    return torch.gather(scores, 1, cols)[:, 0]


def frame_trip_loss(scores: Tensor, generator: torch.Generator,
                    margin: float, use_hard_negative: bool,
                    hard_pool_size: int) -> Tensor:
    """Frame-level bidirectional ranking loss over a square (N, N) score
    matrix with diagonal positives; reference get_frame_trip_loss
    (model.py:389-410). Deterministic when hard_pool_size=1 with hard
    negatives."""
    n = scores.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=scores.device)
    pos = torch.diagonal(scores)
    masked = torch.where(eye, 999.0, scores)
    neg_ctx = sample_neg_scores(scores, masked, generator,
                                use_hard_negative, hard_pool_size)
    neg_q = sample_neg_scores(scores.T, masked.T, generator,
                              use_hard_negative, hard_pool_size)
    return (ranking_loss(pos, neg_ctx, margin)
            + ranking_loss(pos, neg_q, margin))


def batch_kl_loss(predict: Tensor, target: Tensor, temperature: float,
                  valid_q: Optional[Tensor] = None) -> Tensor:
    """Batch-score KL(target || predict) in both directions; reference
    compute_kl_loss mode='batch_score' (model.py:166-182). predict,
    target: (Nq, Nv); `valid_q` (bool (Nq,)) drops padded queries from
    the t2v rows and the v2t columns."""
    nq, nv = predict.shape
    if valid_q is None:
        valid_q = torch.ones(nq, dtype=torch.bool, device=predict.device)
    vf = valid_q.float()
    n_valid = torch.clamp(vf.sum(), min=1.0)

    def kl_rows(p_logits, t_logits, row_mask, col_mask, n_rows):
        p = torch.where(col_mask, p_logits / temperature, NEG_INF)
        t = torch.where(col_mask, t_logits / temperature, NEG_INF)
        log_p = p - torch.logsumexp(p, dim=-1, keepdim=True)
        log_t = t - torch.logsumexp(t, dim=-1, keepdim=True)
        contrib = torch.where(col_mask, torch.exp(log_t) * (log_t - log_p),
                              _zero(log_t))
        return (contrib.sum(dim=-1) * row_mask).sum() / n_rows

    all_cols = torch.ones((nq, nv), dtype=torch.bool, device=predict.device)
    t2v = kl_rows(predict, target, vf, all_cols, n_valid)
    v2t = kl_rows(predict.T, target.T, torch.ones_like(predict[0]),
                  valid_q[None, :], float(nv))
    return t2v + v2t
