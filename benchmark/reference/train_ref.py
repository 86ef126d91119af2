"""The DL-DKD++ training step in plain PyTorch, and the comparison that
decides a training cell's `correct`.

A frozen copy of the published step (HuiGuanLab/DL-DKD method/model.py
forward, method/model_components.py losses, method/optimization.py
BertAdam), written over `reference.model`'s flat parameters, so that it
draws its dropout masks and its negatives from a `torch.Generator` in
the order the step does: every context tower (inheritance, then
exploration), every query tower, then the inheritance and the
exploration triplet losses. It builds its own batches from the inputs
(a permutation from RandomState(seed + epoch), videos of a batch sorted
by caption count, captions video-major, the query axis padded to a
multiple of 64 with label -1), its own schedules and its own optimizer
state: it takes nothing the program made.

`compare_train` holds the program's first steps against it:

  loss_rel_gap     each checked step's loss: |program - reference| /
                   |reference|, the worst step
  grad_norm_gap    each leaf's first gradient as the optimizer got it
                   (from its first moment after one step: m / (1 - b1)),
                   |norm gap| / max(the reference's norm of the leaf, the
                   median leaf's), the worst leaf
  change_norm_gap  each leaf's change over the checked steps, the same

Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of the last two (a key's bias under softmax moves by
round-off alone).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from benchmark.reference import model as ref

NEG_INF = ref.NEG_INF
B1, B2, ADAM_EPS, MAX_GRAD_NORM = 0.9, 0.999, 1e-6, 1.0


# ---------------------------------------------------------------- batches
def epoch_order(n_videos: int, seed: int, epoch: int) -> np.ndarray:
    return np.random.RandomState(seed + epoch).permutation(n_videos)


def build_batch(data: dict, vid_idx: np.ndarray, qpm: int = 64) -> dict:
    """One batch from the host inputs (`data`: vfeats, vmask, tvfeats,
    qfeats, qmask, tqfeats, caps: per video its caption rows)."""
    n_caps = np.asarray([len(data["caps"][i]) for i in vid_idx])
    vid_idx = vid_idx[np.argsort(-n_caps, kind="stable")]
    rows = np.concatenate([data["caps"][i] for i in vid_idx])
    labels = np.concatenate([np.full(len(data["caps"][i]), pos, np.int64)
                             for pos, i in enumerate(vid_idx)])
    n_q = len(rows)
    q_pad = -(-max(n_q, 1) // qpm) * qpm

    def padded(a):
        out = np.zeros((q_pad,) + a.shape[1:], np.float32)
        out[:n_q] = a[rows]
        return out

    lab = np.full(q_pad, -1, np.int64)
    lab[:n_q] = labels
    return {"videos": data["vfeats"][vid_idx],
            "vmask": data["vmask"][vid_idx],
            "tvideos": data["tvfeats"][vid_idx],
            "text": padded(data["qfeats"]), "tmask": padded(data["qmask"]),
            "ttext": padded(data["tqfeats"]), "labels": lab}


# ---------------------------------------------------------------- schedules
def warmup_linear(step: int, warmup: float, t_total: float) -> np.float32:
    f32 = np.float32
    progress = f32(step) / f32(t_total)
    if progress < f32(warmup):
        return progress / f32(max(warmup, 1e-12))
    return np.maximum((progress - f32(1.0)) / f32(warmup - 1.0), f32(0))


def decay(kind: Optional[str], epoch: int, initial: float, floor: float,
          cfg: dict, sigmoid_k: float) -> float:
    if kind in (None, "None"):
        return initial
    if kind == "exp":
        return max(initial * cfg["exponential_k"] ** epoch, floor)
    if kind == "sigmoid":
        return max(initial * (sigmoid_k / (sigmoid_k + math.exp(
            epoch * 100.0 / sigmoid_k))), floor)
    raise ValueError(f"decay {kind!r} is not in the reference")


def epoch_scalars(cfg: dict, epoch: int):
    """kd weight, alpha, belta of the epoch (reference train.py:73-125)."""
    kd = decay(cfg["distill_loss_decay"], epoch, 1.0, -math.inf, cfg,
               cfg["sigmoid_k"])
    alpha = decay(cfg["alpha_decay"], epoch, cfg["alpha"], 0.0, cfg,
                  cfg["selfDistil_sigmoid_k"])
    b_floor = 0.0 if cfg["belta"] < 0.5 else 0.5
    belta = decay(cfg["belta_decay"], epoch, cfg["belta"], b_floor, cfg,
                  cfg["selfDistil_sigmoid_k"])
    return kd, alpha, belta


# ---------------------------------------------------------------- losses
def frame_scores(query, ctx, mask, normalized: bool):
    if normalized:
        query, ctx = ref.l2_normalize(query), ref.l2_normalize(ctx)
    s = torch.einsum("md,nld->mln", query, ctx)
    return ref.mask_logits(s, mask.T[None].to(s.dtype))


def one_hot(labels, nv):
    valid = labels >= 0
    oh = torch.nn.functional.one_hot(torch.where(valid, labels, 0).long(),
                                     nv).float()
    return oh * valid[:, None].float()


def masked_lse(x, mask, dim):
    return torch.logsumexp(torch.where(mask, x, NEG_INF), dim=dim)


def uniform_choice(gen, mask, values):
    u = torch.rand(values.shape, generator=gen, device=values.device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    g = torch.where(mask, -torch.log(-torch.log(u.clamp(min=tiny))),
                    NEG_INF)
    return torch.gather(values, -1, torch.argmax(g, -1)[..., None])[..., 0]


def triplet(scores, labels, gen, margin, hard, pool):
    nq, nv = scores.shape
    valid_f = (labels >= 0).float()
    n_valid = torch.clamp(valid_f.sum(), min=1.0)
    oh = one_hot(labels, nv)
    zero = scores.new_zeros(())
    v2t = scores.T
    neg_mask = ((1.0 - oh.T) * valid_f[None, :]) > 0
    pos_mean = (v2t * oh.T).sum(1) / torch.clamp(oh.T.sum(1), min=1.0)
    neg = (torch.where(neg_mask, v2t, NEG_INF).amax(1) if hard
           else uniform_choice(gen, neg_mask, v2t))
    v2t_loss = torch.maximum(margin + neg - pos_mean, zero).sum()
    pos = (scores * oh).sum(1)
    if hard:
        k = min(1 + pool, nv)
        top = torch.sort(torch.where(oh > 0, 999.0, scores), dim=1,
                         descending=True, stable=True).values[:, :k]
        ranks = torch.randint(1, k, (nq,), generator=gen,
                              device=scores.device)
        neg_t = torch.gather(top, 1, ranks[:, None])[:, 0]
    else:
        neg_t = uniform_choice(gen, oh <= 0, scores)
    t2v = torch.maximum(margin + neg_t - pos, zero) * valid_f
    return t2v.sum() / n_valid + v2t_loss / nv


def nce_soft(scores, sims, labels, alpha, belta):
    nq, nv = scores.shape
    dev = scores.device
    alpha = torch.tensor(alpha, dtype=torch.float32, device=dev)
    belta = torch.tensor(belta, dtype=torch.float32, device=dev)
    valid_q = labels >= 0
    n_valid = valid_q.sum()
    zero = scores.new_zeros(())
    hard_q = torch.floor(alpha * n_valid).long()
    soft_q = n_valid - hard_q
    hard_v = torch.floor(alpha * nv).long()
    soft_v = nv - hard_v
    q_idx = torch.arange(nq, device=dev)
    v_idx = torch.arange(nv, device=dev)
    is_hard_q = (q_idx < hard_q) & valid_q
    is_soft_q = (q_idx >= hard_q) & valid_q
    is_hard_v, is_soft_v = v_idx < hard_v, v_idx >= hard_v
    oh = one_hot(labels, nv)
    i_q = torch.where(is_soft_q[:, None], torch.maximum(
        (1.0 - belta) * torch.softmax(sims, -1) + belta * oh, zero), oh)
    t2v = i_q.sum(1) * torch.logsumexp(scores, 1) - (i_q * scores).sum(1)
    t2v_hard = (t2v * is_hard_q.float()).sum()
    t2v_soft = (t2v * is_soft_q.float()).sum()
    sims_v = torch.softmax(torch.where(valid_q[None, :], sims.T, NEG_INF),
                           -1)
    i_v = torch.where(is_soft_v[:, None], torch.maximum(
        (1.0 - belta) * sims_v + belta * oh.T, zero), oh.T)
    cols = valid_q[None, :].expand(nv, nq)
    v2t = (masked_lse(scores.T, cols, 1)
           - masked_lse(torch.log(i_v + 1e-12) + scores.T, cols, 1))
    v2t_hard = (v2t * is_hard_v.float()).sum()
    v2t_soft = (v2t * is_soft_v.float()).sum()
    hard = torch.where((hard_q > 0) & (hard_v > 0),
                       t2v_hard / torch.clamp(hard_q, min=1)
                       + v2t_hard / torch.clamp(hard_v, min=1), zero)
    soft = torch.where((soft_q > 0) & (soft_v > 0),
                       t2v_soft / torch.clamp(soft_q, min=1)
                       + v2t_soft / torch.clamp(soft_v, min=1), zero)
    return alpha * hard + (1.0 - alpha) * soft


def frame_kl(student, teacher, vmask, labels, temperature=0.2):
    nq, l, _ = student.shape
    valid_q = labels >= 0
    safe = torch.where(valid_q, labels, 0).long()
    idx = safe[:, None, None].expand(nq, l, 1)
    p = torch.gather(student, 2, idx)[..., 0]
    t = torch.gather(teacher, 2, idx)[..., 0]
    fmask = vmask[safe] > 0

    def log_softmax(x):
        z = torch.where(fmask, x / temperature, NEG_INF)
        return z - torch.logsumexp(z, -1, keepdim=True)

    log_p, log_t = log_softmax(p), log_softmax(t)
    c = torch.where(fmask, torch.exp(log_t) * (log_t - log_p),
                    log_t.new_zeros(()))
    return (c.sum(-1) * valid_q.float()).sum()


def loss(P: ref.Params, cfg: dict, b: dict, gen, scalars) -> torch.Tensor:
    kd, alpha, belta = scalars
    names = ref.branches(cfg)
    ctx = [ref.encode_context(P, cfg, br, b["videos"], b["vmask"], gen)
           for br in names]
    qry = [ref.encode_query(P, cfg, br, b["text"], b["tmask"], gen)
           for br in names]
    labels, vmask = b["labels"], b["vmask"]
    t_frame = frame_scores(b["ttext"], b["tvideos"], vmask, True)
    t_raw = frame_scores(b["ttext"], b["tvideos"], vmask, False).amax(1)
    hard, pool = cfg["use_hard_negative"], cfg["hard_pool_size"]
    i_frame = frame_scores(qry[0], ctx[0], vmask, True)
    i_raw = frame_scores(qry[0], ctx[0], vmask, False).amax(1)
    total = triplet(i_frame.amax(1), labels, gen, cfg["margin"], hard, pool)
    total = total + cfg["inher_nce_weight"] * nce_soft(i_raw, t_raw, labels,
                                                       alpha, belta)
    total = total + cfg["kl_intra_weight"] * kd * frame_kl(
        i_frame, t_frame, vmask, labels)
    if len(names) == 2:
        e_cos = frame_scores(qry[1], ctx[1], vmask, True).amax(1)
        e_raw = frame_scores(qry[1], ctx[1], vmask, False).amax(1)
        total = total + triplet(e_cos, labels, gen, cfg["margin"], hard,
                                pool)
        total = total + cfg["explore_nce_weight"] * nce_soft(
            e_raw, e_raw, labels, alpha, belta)
    return total


# ---------------------------------------------------------------- optimizer
class BertAdam:
    """The reference BertAdam: per-leaf clip to norm 1, no bias
    correction, decoupled-by-hand weight decay off biases and LayerNorms,
    the schedule at the count of previous updates."""

    def __init__(self, P: ref.Params, lr: float, warmup: float,
                 t_total: float, wd: float):
        self.P, self.lr, self.warmup, self.t_total = P, lr, warmup, t_total
        self.wd = {n: 0.0 if (n.endswith(".bias") or "LayerNorm" in
                              n.split(".")) else wd for n in P}
        self.m = {n: torch.zeros_like(p) for n, p in P.items()}
        self.v = {n: torch.zeros_like(p) for n, p in P.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        scale = float(np.float32(self.lr) * warmup_linear(
            self.count, self.warmup, self.t_total))
        for n, p in self.P.items():
            g = grads[n]
            norm = torch.sqrt(torch.sum(g * g))
            g = g * torch.clamp(MAX_GRAD_NORM / (norm + 1e-6), max=1.0)
            m = self.m[n].mul_(B1).add_((1 - B1) * g)
            v = self.v[n].mul_(B2).add_((1 - B2) * g * g)
            p.add_(-scale * (m / (torch.sqrt(v) + ADAM_EPS)
                             + self.wd[n] * p))
        self.count += 1


def reference_steps(P0: ref.Params, cfg: dict, data: dict, loader_seed: int,
                    gen_seed: int, n_steps: int, device,
                    exact: bool = True) -> dict:
    """Run the first `n_steps` steps of epoch 0 from P0; returns the
    losses, each leaf's first-step gradient norm (as the optimizer
    clipped it) and each leaf's change over the steps. exact=False runs
    the products in TF32: the control."""
    P = {k: v.detach().to(device).clone().requires_grad_(True)
         for k, v in P0.items()}
    start = {k: v.detach().clone() for k, v in P.items()}
    opt = BertAdam(P, cfg["lr"], cfg["lr_warmup_proportion"],
                   cfg["t_total"], cfg["wd"])
    gen = torch.Generator(device=device).manual_seed(gen_seed)
    order = epoch_order(len(data["caps"]), loader_seed, 0)
    scalars = epoch_scalars(cfg, 0)
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    with ref.exact_f32(exact):
        for i in range(n_steps):
            idx = order[i * cfg["bsz"]:(i + 1) * cfg["bsz"]]
            b = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                 for k, v in build_batch(data, idx).items()}
            total = loss(P, cfg, b, gen, scalars)
            grads = torch.autograd.grad(total, list(P.values()),
                                        allow_unused=True)
            grads = {n: torch.zeros_like(p) if g is None else g
                     for (n, p), g in zip(P.items(), grads)}
            opt.step(grads)
            losses.append(float(total.detach()))
            if i == 0:
                grad_norms = {n: float(m.norm()) / (1 - B1)
                              for n, m in opt.m.items()}
    change = {n: float((P[n].detach() - start[n]).norm()) for n in P}
    return {"losses": losses, "grad_norms": grad_norms, "change": change}


def _worst_leaf_gap(prog: Dict[str, float], refv: Dict[str, float],
                    leaves: Sequence[str]) -> float:
    med = float(np.median([refv[n] for n in leaves]))
    return max(abs(prog[n] - refv[n]) / max(refv[n], med, 1e-30)
               for n in leaves)


def compare_train(prog: dict, reference: dict) -> Dict[str, float]:
    """`prog` and `reference` as `reference_steps` returns them."""
    g = reference["grad_norms"]
    med = float(np.median(list(g.values())))
    leaves = [n for n in g if g[n] >= 1e-3 * med]
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in
                   zip(prog["losses"], reference["losses"]))
    if len(prog["losses"]) != len(reference["losses"]):
        loss_gap = math.inf
    return {"loss_rel_gap": loss_gap,
            "grad_norm_gap": _worst_leaf_gap(prog["grad_norms"], g, leaves),
            "change_norm_gap": _worst_leaf_gap(prog["change"],
                                               reference["change"], leaves)}
