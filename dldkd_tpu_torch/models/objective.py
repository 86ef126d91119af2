"""Training objective: loss assembly over a batch (port of
dldkd_tpu/models/objective.py:27-138).

Reproduces reference `DLDKD.forward` (method/model.py:100-163):

  loss = inher_trip
       + inher_nce_weight   * (clip_nce | clip_nce_soft vs teacher)
       + kl_intra_weight * kd_weight * frame_KL(student, teacher, T=0.2)
       + explore_trip
       + explore_nce_weight * (clip_nce | clip_nce_soft vs itself)

kd_weight / alpha / belta are the per-epoch decay scalars
(optim/schedules.py), float32 tensors on the step's device. The towers run
sequentially, or both branches as one stacked computation with
`--stacked_towers` (models/stacked.py), in the model's compute dtype; every
loss is computed in float32 (the tower outputs are cast first, as
dldkd_tpu/models/objective.py:76-83 does).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from dldkd_tpu_torch.config import ModelConfig, TrainConfig
from dldkd_tpu_torch.models.stacked import can_stack, encode_stacked
from dldkd_tpu_torch.ops import losses
from dldkd_tpu_torch.ops.similarity import (clip_scores,
                                            clip_scores_unnormalized)


class LossScalars(NamedTuple):
    """Per-epoch decayed scalars (see optim/schedules.py)."""

    kd_weight: torch.Tensor  # distill loss decay, reference train.py:73-82
    alpha: torch.Tensor      # soft-NCE partition threshold, train.py:85-104
    belta: torch.Tensor      # GT/soft mixing, train.py:106-125


def check_trainable(mcfg: ModelConfig, tcfg: TrainConfig) -> None:
    """Raise on a training setting that cannot run, before any data is
    packed: --stacked_towers without two branches of one hidden size."""
    if tcfg.stacked_towers and not can_stack(mcfg):
        raise ValueError(
            "--stacked_towers needs --double_branch with equal "
            "inheritance and exploration hidden sizes (stacked towers "
            "run both branches as one computation)")


def compute_losses(model, batch: Dict[str, torch.Tensor],
                   generator: torch.Generator, mcfg: ModelConfig,
                   tcfg: TrainConfig, scalars: LossScalars, group=None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full training loss for one batch, with the dropout masks (in
    training mode) and the negatives drawn from `generator`.

    batch keys (static shapes, see data/pipeline.py):
      student_videos (B, Lv, Dv), student_videos_mask (B, Lv),
      teacher_videos (B, Lv, Dt), student_text (Q, Lq, Dq),
      student_text_mask (Q, Lq), teacher_text (Q, Dt),
      text_labels (Q,) int with -1 padding.
    mcfg is the epoch's model config (hard negatives flip per epoch), not
    necessarily model.config.

    group: a data-parallel process group (parallel/train_dp.py). Then
    student_videos and student_text hold this rank's rows
    (`shard_batch_multihost`), the rest the whole batch: the towers run
    on this rank's rows and their outputs are gathered from every rank
    before the whole batch's losses.
    """
    own_vmask, own_tmask, draws = (batch["student_videos_mask"],
                                   batch["student_text_mask"], generator)
    if group is not None:
        from dldkd_tpu_torch.parallel import train_dp

        own_vmask = train_dp.local_rows(own_vmask, group)
        own_tmask = train_dp.local_rows(own_tmask, group)
        draws = train_dp.batch_shard(generator, group)
    args = (batch["student_videos"], own_vmask, batch["student_text"],
            own_tmask)
    if tcfg.stacked_towers:
        outs = encode_stacked(model, *args, generator=draws)
    else:
        outs = model(*args, generator=draws)
    # bf16 towers: every loss in f32 (params and optimizer are f32 too)
    outs = tuple(tuple(t.float() if t is not None and t.dtype ==
                       torch.bfloat16 else t for t in pair) for pair in outs)
    if group is not None:
        outs = train_dp.gather_outputs(outs, group)
    (inher_ctx, explore_ctx), (inher_q, explore_q) = outs

    vmask = batch["student_videos_mask"]
    labels = batch["text_labels"].long()

    # teacher scores straight from the precomputed CLIP features
    # (reference model.py:113-116: the teacher has no runtime parameters)
    _, teacher_frame = clip_scores(batch["teacher_text"],
                                   batch["teacher_videos"], vmask)
    teacher_raw = clip_scores_unnormalized(
        batch["teacher_text"], batch["teacher_videos"], vmask)

    inher_cos, inher_frame = clip_scores(inher_q, inher_ctx, vmask)
    inher_raw = clip_scores_unnormalized(inher_q, inher_ctx, vmask)

    inher_trip = losses.clip_triplet_loss(
        inher_cos, labels, generator, mcfg.margin, mcfg.use_hard_negative,
        mcfg.hard_pool_size)
    if mcfg.label_style == "soft":
        inher_nce = tcfg.inher_nce_weight * losses.clip_nce_soft(
            inher_raw, teacher_raw, labels, scalars.alpha, scalars.belta)
    else:
        inher_nce = tcfg.inher_nce_weight * losses.clip_nce(inher_raw,
                                                            labels)

    kl_intra = tcfg.kl_intra_weight * scalars.kd_weight * \
        losses.frame_kl_loss(inher_frame, teacher_frame, vmask, labels,
                             temperature=0.2)

    zero = torch.zeros((), dtype=torch.float32, device=inher_cos.device)
    explore_trip, explore_nce = zero, zero
    if mcfg.double_branch:
        explore_cos, _ = clip_scores(explore_q, explore_ctx, vmask)
        explore_raw = clip_scores_unnormalized(explore_q, explore_ctx,
                                               vmask)
        explore_trip = losses.clip_triplet_loss(
            explore_cos, labels, generator, mcfg.margin,
            mcfg.use_hard_negative, mcfg.hard_pool_size)
        if mcfg.label_style == "soft":
            # self-distillation: the branch's own scores are the soft
            # target (reference model.py:149-150)
            explore_nce = tcfg.explore_nce_weight * losses.clip_nce_soft(
                explore_raw, explore_raw, labels, scalars.alpha,
                scalars.belta)
        else:
            explore_nce = tcfg.explore_nce_weight * losses.clip_nce(
                explore_raw, labels)

    loss = inher_trip + inher_nce + kl_intra + explore_trip + explore_nce
    loss_dict = {
        "loss_overall": loss,
        "inher_trip": inher_trip,
        "inher_nce": inher_nce,
        "explore_trip": explore_trip,
        "explore_nce": explore_nce,
        "kl": kl_intra,
        "kl_intra": kl_intra,
    }
    return loss, loss_dict
