"""Faults planted in the program's timed path, which `correct` has to
catch: the benchmark's tests plant them on the CPU, and `control.py
--fault` reads them on the card at a cell's size. Each `plant()` returns
a function that takes the fault out again."""

from __future__ import annotations

from typing import Callable


def _swap(owner, name: str, new) -> Callable[[], None]:
    old = getattr(owner, name)
    setattr(owner, name, new)
    return lambda: setattr(owner, name, old)


def alter_scores() -> Callable[[], None]:
    """One answer altered where it is produced: each score matrix the
    eval's scorer returns has its first entry moved by 1e-3."""
    from dldkd_tpu_torch import evaluate

    plain = evaluate.clip_scores_maxpool

    def altered(*args, **kwargs):
        s = plain(*args, **kwargs)
        s[0, 0] += 1e-3
        return s

    return _swap(evaluate, "clip_scores_maxpool", altered)


def unchanged_state() -> Callable[[], None]:
    """A training step that returns its state unchanged: BertAdam's update
    does nothing."""
    from dldkd_tpu_torch.optim import BertAdam

    return _swap(BertAdam, "step", lambda self, grads: None)


def half_batch() -> Callable[[], None]:
    """Half of the batch left out, the mean taken over the rest: the loss
    of the batch's first half of videos and their captions (a prefix of
    the caption axis: captions are laid out video-major)."""
    from dldkd_tpu_torch import train

    plain = train.compute_losses

    def half(model, batch, *args, **kwargs):
        b = batch["student_videos"].shape[0] // 2
        labels = batch["text_labels"]
        rows = int(((labels >= 0) & (labels < b)).sum())
        cut = dict(batch)
        for k in ("student_videos", "student_videos_mask", "teacher_videos"):
            cut[k] = batch[k][:b]
        for k in ("student_text", "student_text_mask", "teacher_text",
                  "text_labels"):
            cut[k] = batch[k][:rows]
        return plain(model, cut, *args, **kwargs)

    return _swap(train, "compute_losses", half)


def alter_search_scores() -> Callable[[], None]:
    """One answer altered where it is produced: the first returned score
    of each `Retriever.search` moved by 1e-3."""
    import numpy as np

    from dldkd_tpu_torch import serving

    plain = serving.Retriever.search

    def altered(self, *args, **kwargs):
        scores, ids = plain(self, *args, **kwargs)
        scores = np.array(scores)
        scores[0, 0] += 1e-3
        return scores, ids

    return _swap(serving.Retriever, "search", altered)


FAULTS = {"alter_scores": alter_scores, "unchanged_state": unchanged_state,
          "half_batch": half_batch,
          "alter_search_scores": alter_search_scores}
