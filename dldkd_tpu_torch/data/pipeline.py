"""Static-shape training batches and their copy to the device (port of
dldkd_tpu/data/pipeline.py).

The loader is numpy only and yields the JAX package's batches bitwise:
a per-epoch permutation from RandomState(seed + epoch) (or a recorded
order), videos of a batch sorted by caption count (descending, stable),
captions laid out video-major so valid queries form a prefix (the soft-NCE
alpha-partition depends on that order, reference data_provider.py:117),
and the query axis padded to a multiple of query_pad_multiple with label
-1.

`device_prefetch` assembles batches in a producer thread and puts each on
the device ahead of its step: on a CUDA device from pinned host memory
with a non-blocking copy.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from dldkd_tpu_torch.data.ingest import TrainData


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


class TrainLoader:
    """Deterministic, seeded epoch iterator over host batches.

    epoch_order: optional per-epoch video-ID sequences replayed verbatim
    instead of the seeded shuffle (trajectory tests against another
    stack's recorded sampler order). drop_last: skip the short last batch,
    as a data-parallel run does (its video axis would not divide the
    processes; the per-epoch permutation still visits every video across
    epochs); otherwise every batch is kept."""

    def __init__(self, data: TrainData, bsz: int, seed: int = 9527,
                 query_pad_multiple: int = 64, drop_last: bool = False,
                 epoch_order=None):
        self.data = data
        self.bsz = bsz
        self.seed = seed
        self.qpm = query_pad_multiple
        self.drop_last = drop_last
        self.n_videos = len(data.videos)
        self.epoch_order = epoch_order
        if epoch_order is not None:
            self._id_to_idx = {v: i for i, v in enumerate(data.videos.ids)}

    def steps_per_epoch(self) -> int:
        if self.drop_last:
            return self.n_videos // self.bsz
        return (self.n_videos + self.bsz - 1) // self.bsz

    def epoch(self, epoch_idx: int) -> Iterator[Dict[str, np.ndarray]]:
        if self.epoch_order is not None:
            order = self.epoch_order[epoch_idx]
            assert len(order) == self.n_videos
            perm = np.asarray([self._id_to_idx[v] for v in order])
        else:
            rng = np.random.RandomState(self.seed + epoch_idx)
            perm = rng.permutation(self.n_videos)
        for start in range(0, self.n_videos, self.bsz):
            vid_idx = perm[start:start + self.bsz]
            if len(vid_idx) < self.bsz and self.drop_last:
                break
            yield self._build_batch(vid_idx)

    def _build_batch(self, vid_idx: np.ndarray) -> Dict[str, np.ndarray]:
        d = self.data
        # sort by #captions descending (stable, like python list.sort)
        n_caps = np.asarray([len(d.vid_cap_index[i]) for i in vid_idx])
        order = np.argsort(-n_caps, kind="stable")
        vid_idx = vid_idx[order]

        cap_rows = np.concatenate([d.vid_cap_index[i] for i in vid_idx])
        labels = np.concatenate([
            np.full(len(d.vid_cap_index[i]), pos, np.int32)
            for pos, i in enumerate(vid_idx)])
        n_q = len(cap_rows)
        q_pad = _round_up(max(n_q, 1), self.qpm)

        text = np.zeros((q_pad,) + d.queries.feats.shape[1:], np.float32)
        text[:n_q] = d.queries.feats[cap_rows]
        tmask = np.zeros((q_pad, d.queries.mask.shape[1]), np.float32)
        tmask[:n_q] = d.queries.mask[cap_rows]
        t_text = np.zeros((q_pad, d.queries.teacher_feats.shape[1]),
                          np.float32)
        t_text[:n_q] = d.queries.teacher_feats[cap_rows]
        pad_labels = np.full(q_pad, -1, np.int32)
        pad_labels[:n_q] = labels

        return {
            "student_videos": d.videos.feats[vid_idx],
            "student_videos_mask": d.videos.mask[vid_idx],
            "teacher_videos": d.videos.teacher_feats[vid_idx],
            "student_text": text,
            "student_text_mask": tmask,
            "teacher_text": t_text,
            "text_labels": pad_labels,
        }


def device_prefetch(iterator: Iterator[dict], device, size: int = 2
                    ) -> Iterator[Dict[str, torch.Tensor]]:
    """Run host batch assembly and the copy to `device` in a background
    thread, `size` batches ahead of consumption (the reference's
    pin_memory + worker-pool role, config.py:32-36). On a CUDA device each
    array goes through pinned memory with a non-blocking copy, on the
    consumer's stream, so it is ordered before the step that reads it."""
    dev = torch.device(device)
    q: queue_mod.Queue = queue_mod.Queue(maxsize=size)
    end = object()
    err: list = []
    stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None

    def put(batch):
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = (t.pin_memory().to(dev, non_blocking=True)
                      if stream is not None else t)
        return out

    def producer():
        try:
            if stream is not None:
                torch.cuda.set_stream(stream)
            for item in iterator:
                q.put(put(item))
        except BaseException as e:  # surfaced on the consumer side
            err.append(e)
        finally:
            q.put(end)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is end:
            t.join()
            if err:
                raise err[0]
            return
        yield item
