"""Synthetic mini-dataset in the reference's exact on-disk layout.

Generates a BigFile + video2frames.txt + caption files + the three HDF5
feature files, with planted cross-modal structure (videos and their captions
share a latent) so end-to-end training measurably improves retrieval. Used
by tests and by chip_smoke.py — the real TVR/ActivityNet/Charades features are
not redistributable. feature_format="npz" writes the three feature stores as
.npz archives with the same keys instead (data.ingest.open_features reads
either), for machines without h5py; the content is the same.
"""

from __future__ import annotations

import os
from contextlib import ExitStack

import numpy as np

from dldkd_tpu_torch.data.bigfile import BigFileWriter


def generate_dataset(
    root: str,
    collection: str = "synthetic",
    visual_feature: str = "i3d",
    n_videos: dict | None = None,
    caps_per_video: tuple = (2, 5),
    frames_range: tuple = (20, 200),
    teacher_frames_range: tuple = (8, 64),
    tokens_range: tuple = (5, 30),
    d_student: int = 64,
    d_query: int = 48,
    d_teacher: int = 32,
    d_latent: int = 16,
    noise: float = 0.6,
    seed: int = 0,
    feature_format: str = "hdf5",
) -> str:
    """Write the dataset under root/collection; returns the collection dir.
    The same arguments and seed give the same data as the JAX package's
    generator."""
    if feature_format == "hdf5":
        import h5py

        def open_store(path):
            return h5py.File(path, "w")
    elif feature_format == "npz":
        def open_store(path):
            return _NpzWriter(os.path.splitext(path)[0] + ".npz")
    else:
        raise ValueError(f"feature_format {feature_format!r}: use hdf5 or npz")

    n_videos = n_videos or {"train": 40, "val": 16, "test": 16}
    rng = np.random.RandomState(seed)
    base = os.path.join(root, collection)
    feat_dir = os.path.join(base, "FeatureData", visual_feature)
    text_dir = os.path.join(base, "TextData")
    os.makedirs(feat_dir, exist_ok=True)
    os.makedirs(text_dir, exist_ok=True)

    w_student = rng.randn(d_latent, d_student) / np.sqrt(d_latent)
    w_query = rng.randn(d_latent, d_query) / np.sqrt(d_latent)
    w_teacher = rng.randn(d_latent, d_teacher) / np.sqrt(d_latent)

    video2frames = {}
    tv_path = os.path.join(
        base, "FeatureData", f"new_clip_vit_32_{collection}_vid_features.hdf5")
    tq_path = os.path.join(
        text_dir, f"clip_ViT_B_32_{collection}_query_feat.hdf5")
    q_path = os.path.join(text_dir, f"roberta_{collection}_query_feat.hdf5")

    with ExitStack() as stack:
        bf = stack.enter_context(BigFileWriter(feat_dir, d_student))
        tv, tq, qf = (stack.enter_context(open_store(p))
                      for p in (tv_path, tq_path, q_path))
        for split, n_vid in n_videos.items():
            lines = []
            for v in range(n_vid):
                vid = f"{collection}_{split}_v{v:04d}"
                z = rng.randn(d_latent)
                n_frames = rng.randint(*frames_range)
                frame_ids = [f"{vid}_{t}" for t in range(n_frames)]
                # one draw for all frames: the same stream (and bytes) as a
                # draw per frame, without the per-frame Python loop
                frames = z @ w_student + noise * rng.randn(n_frames,
                                                           d_student)
                bf.write_rows(frame_ids, frames.astype(np.float32))
                video2frames[vid] = frame_ids

                n_tf = rng.randint(*teacher_frames_range)
                t_frames = (np.tile(z, (n_tf, 1)) @ w_teacher
                            + noise * rng.randn(n_tf, d_teacher))
                tv.create_dataset(vid, data=t_frames.astype(np.float32))

                n_caps = rng.randint(caps_per_video[0],
                                     caps_per_video[1] + 1)
                for j in range(n_caps):
                    cap_id = f"{vid}#enc#{j}"
                    lines.append(f"{cap_id} synthetic caption {v} {j}")
                    n_tok = rng.randint(*tokens_range)
                    toks = (np.tile(z, (n_tok, 1)) @ w_query
                            + noise * rng.randn(n_tok, d_query))
                    qf.create_dataset(cap_id, data=toks.astype(np.float32))
                    sent = z @ w_teacher + noise * rng.randn(d_teacher)
                    # teacher text keyed WITHOUT '#enc#' for some caps, to
                    # exercise the reference's key-fallback path
                    key = cap_id if (v + j) % 3 else "#".join(cap_id.split("#enc#"))
                    tq.create_dataset(key, data=sent[None].astype(np.float32))
            with open(os.path.join(text_dir,
                                   f"{collection}{split}.caption.txt"), "w") as f:
                f.write("\n".join(lines) + "\n")

    with open(os.path.join(feat_dir, "video2frames.txt"), "w") as f:
        f.write(repr(video2frames))
    return base


class _NpzWriter:
    """The `create_dataset` surface of an h5py file, written as one .npz
    archive when the block exits without an error."""

    def __init__(self, path: str):
        self.path = path
        self.arrays = {}

    def create_dataset(self, key: str, data: np.ndarray) -> None:
        self.arrays[key] = data

    def __enter__(self) -> "_NpzWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            np.savez(self.path, **self.arrays)
