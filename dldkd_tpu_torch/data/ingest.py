"""Dataset ingestion: BigFile/HDF5 -> packed padded arrays.

The PyTorch port's own copy of `dldkd_tpu/data/ingest.py` (same packing
conventions, so both packages train on and score identical inputs). The
corpus and training packers gather, resample and normalize the student
frames with the native C++ packer (`data/native.py`) where it is available,
as the JAX package does, else with numpy (one f32 ulp apart:
$DLDKD_NO_NATIVE=1, no g++, or a float16 BigFile).

On-disk layout consumed (SURVEY.md S2.3):
  $root/$collection/FeatureData/$visual_feature/          BigFile + video2frames.txt
  $root/$collection/FeatureData/new_clip_vit_32_{c}_vid_features.hdf5
  $root/$collection/TextData/{c}{split}.caption.txt
  $root/$collection/TextData/roberta_{c}_query_feat.hdf5
  $root/$collection/TextData/clip_ViT_B_32_{c}_query_feat.hdf5
Each feature store may instead be an .npz archive with the same keys
beside where the HDF5 file would be (for machines without h5py).
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from dldkd_tpu_torch.data.bigfile import BigFile


def read_dict(path: str) -> dict:
    """Parse video2frames.txt (a python-literal dict). The reference uses
    eval() (basic_utils.py:231-236); we use ast.literal_eval — same data,
    no code execution."""
    with open(path) as f:
        return ast.literal_eval(f.read().strip())


def l2_normalize_rows(x: np.ndarray, eps: float = 1e-5) -> np.ndarray:
    """Reference l2_normalize_np_array (data_provider.py:71-73): note the
    eps is ADDED to the norm, not a lower bound."""
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + eps)


def uniform_feature_sampling(features: np.ndarray, max_len: Optional[int]) -> np.ndarray:
    """Temporal downsampling: mean-pool contiguous bins to exactly max_len
    frames when longer (reference data_provider.py:52-68 — the long-context
    mechanism, SURVEY.md S5.7). Vectorized with a cumulative sum."""
    num_clips = features.shape[0]
    if max_len is None or num_clips <= max_len:
        return features
    idxs = np.round(np.arange(0, max_len + 1, 1.0) / max_len * num_clips).astype(np.int64)
    idxs[idxs > num_clips - 1] = num_clips - 1
    s, e = idxs[:-1], idxs[1:]
    cs = np.concatenate([np.zeros((1,) + features.shape[1:], np.float64),
                         np.cumsum(features, axis=0, dtype=np.float64)])
    cnt = (e - s).astype(np.float64)
    pooled = np.where(cnt[:, None] > 0,
                      (cs[e] - cs[s]) / np.maximum(cnt[:, None], 1.0),
                      features[s].astype(np.float64))
    return pooled.astype(features.dtype)


def load_captions(cap_file: str) -> Tuple[List[str], Dict[str, str],
                                          List[str], Dict[str, List[str]]]:
    """Parse a caption file into (cap_ids, captions, video_ids, vid_caps),
    preserving first-seen order (reference data_provider.py:185-197)."""
    cap_ids: List[str] = []
    captions: Dict[str, str] = {}
    video_ids: List[str] = []
    vid_caps: Dict[str, List[str]] = {}
    with open(cap_file) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            cap_id, caption = line.split(" ", 1)
            video_id = cap_id.split("#")[0]
            captions[cap_id] = caption
            cap_ids.append(cap_id)
            if video_id not in vid_caps:
                video_ids.append(video_id)
                vid_caps[video_id] = []
            vid_caps[video_id].append(cap_id)
    return cap_ids, captions, video_ids, vid_caps


def read_video_ids(cap_file: str) -> List[str]:
    """Dedup-ordered video ids (reference data_provider.py:20-28)."""
    return load_captions(cap_file)[2]


# --------------------------------------------------------------------- #
# Packed containers
# --------------------------------------------------------------------- #

@dataclass
class PackedVideos:
    """Padded frame features for a set of videos."""

    feats: np.ndarray          # (N, L, D) float32
    mask: np.ndarray           # (N, L) float32, 1=valid
    ids: List[str]
    teacher_feats: Optional[np.ndarray] = None  # (N, L, Dt), raw CLIP

    def __len__(self):
        return len(self.ids)


@dataclass
class PackedQueries:
    """Padded token features for a set of captions."""

    feats: np.ndarray                 # (Ncap, Lq, Dq) float32, L2-normalized
    mask: np.ndarray                  # (Ncap, Lq) float32
    cap_ids: List[str]
    video_ids: List[str]              # per caption
    teacher_feats: Optional[np.ndarray] = None  # (Ncap, Dt) raw CLIP sentence

    def __len__(self):
        return len(self.cap_ids)


@dataclass
class TrainData:
    videos: PackedVideos
    queries: PackedQueries
    vid_cap_index: List[np.ndarray]   # per video: caption row indices

    @property
    def max_caps_per_video(self) -> int:
        return max(len(c) for c in self.vid_cap_index)


# --------------------------------------------------------------------- #
# Packing
# --------------------------------------------------------------------- #

def _frame_row_indices(visual_feat: BigFile, video2frames: dict,
                       video_ids: List[str]) -> List[np.ndarray]:
    n2i = visual_feat.name2index
    return [np.asarray([n2i[f] for f in video2frames[v]], np.int64)
            for v in video_ids]


def _pack_student_native(visual_feat: BigFile, video2frames: dict,
                         video_ids: List[str],
                         align_len: Optional[np.ndarray],
                         max_ctx_l: int) -> Optional[Tuple[np.ndarray,
                                                           np.ndarray]]:
    """Gather, resample and normalize every video's student frames through
    the C++ thread pool (dldkd_tpu/data/ingest.py:149-162); None -> the
    caller takes the numpy path."""
    if visual_feat.dtype != np.float32:
        return None  # a float16 BigFile: the numpy path
    from dldkd_tpu_torch.data.native import pack_corpus_native

    return pack_corpus_native(
        visual_feat.bin_path, visual_feat.ndims,
        _frame_row_indices(visual_feat, video2frames, video_ids),
        align_len, max_ctx_l)


def _teacher_text_key(store, cap_id: str) -> str:
    """CLIP text stores sometimes key caps as 'vid#j' instead of
    'vid#enc#j' (reference fallback, data_provider.py:250-257)."""
    if cap_id in store:
        return cap_id
    alt = "#".join(cap_id.split("#enc#"))
    if alt in store:
        return alt
    raise KeyError(cap_id)


def pack_train_dataset(
    cap_file: str,
    visual_feat: BigFile,
    video2frames: dict,
    text_feat_path: str,
    teacher_vid_feat_path: str,
    teacher_text_feat_path: str,
    max_ctx_l: int = 128,
    max_desc_l: int = 30,
) -> TrainData:
    """Reference Dataset4DLDKD.__getitem__ semantics (data_provider.py:212-263)
    applied to the whole split once:
      student frames -> resample to TEACHER frame count -> resample to
      max_ctx_l -> L2-normalize; teacher frames resampled to max_ctx_l, raw.
      Captions: RoBERTa tokens L2-normalized, truncated to max_desc_l;
      CLIP sentence feats raw.
    """
    _, _, video_ids, vid_caps = load_captions(cap_file)
    n_vid = len(video_ids)
    with open_features(teacher_vid_feat_path) as tv:
        # teacher lengths first: the student grid aligns to them
        t_lens = np.asarray([tv[vid].shape[0] for vid in video_ids],
                            np.int64)
        t_dim = np.asarray(tv[video_ids[0]]).shape[1]
        t_feats = np.zeros((n_vid, max_ctx_l, t_dim), np.float32)
        packed = _pack_student_native(visual_feat, video2frames, video_ids,
                                      t_lens, max_ctx_l)
        if packed is not None:
            feats, mask = packed
            for i, vid in enumerate(video_ids):
                teacher = uniform_feature_sampling(
                    np.asarray(tv[vid][:], np.float32), max_ctx_l)
                t_feats[i, :teacher.shape[0]] = teacher
        else:
            feats = np.zeros((n_vid, max_ctx_l, visual_feat.ndims),
                             np.float32)
            mask = np.zeros((n_vid, max_ctx_l), np.float32)
            for i, vid in enumerate(video_ids):
                teacher = np.asarray(tv[vid][:], np.float32)
                student = visual_feat.read(video2frames[vid])
                # align the student frame grid to the teacher's, then cap
                student = uniform_feature_sampling(student,
                                                   teacher.shape[0])
                student = uniform_feature_sampling(student, max_ctx_l)
                teacher = uniform_feature_sampling(teacher, max_ctx_l)
                # after alignment both have at most the teacher's length
                n = min(student.shape[0], teacher.shape[0])
                feats[i, :n] = l2_normalize_rows(student[:n])
                t_feats[i, :teacher.shape[0]] = teacher
                mask[i, :n] = 1.0

    videos = PackedVideos(feats=feats, mask=mask, ids=video_ids,
                          teacher_feats=t_feats)
    queries = pack_query_set(cap_file, text_feat_path, max_desc_l,
                             teacher_text_feat_path=teacher_text_feat_path)
    cap_row = {c: i for i, c in enumerate(queries.cap_ids)}
    vid_cap_index = [np.asarray([cap_row[c] for c in vid_caps[v]], np.int64)
                     for v in video_ids]
    return TrainData(videos=videos, queries=queries,
                     vid_cap_index=vid_cap_index)


def pack_video_corpus(
    video_ids: List[str],
    visual_feat: BigFile,
    video2frames: dict,
    max_ctx_l: int = 128,
) -> PackedVideos:
    """Eval corpus videos (reference VisDataSet4DLDKD, data_provider.py:268-312):
    no teacher alignment (teacher_feat is always None at eval), resample to
    max_ctx_l, L2-normalize."""
    packed = _pack_student_native(visual_feat, video2frames, list(video_ids),
                                  None, max_ctx_l)
    if packed is not None:
        return PackedVideos(feats=packed[0], mask=packed[1],
                            ids=list(video_ids))
    n = len(video_ids)
    feats = np.zeros((n, max_ctx_l, visual_feat.ndims), np.float32)
    mask = np.zeros((n, max_ctx_l), np.float32)
    for i, vid in enumerate(video_ids):
        student = visual_feat.read(video2frames[vid])
        student = uniform_feature_sampling(student, max_ctx_l)
        m = student.shape[0]
        feats[i, :m] = l2_normalize_rows(student)
        mask[i, :m] = 1.0
    return PackedVideos(feats=feats, mask=mask, ids=list(video_ids))


def pack_query_rows(h5, cap_ids: List[str], max_desc_l: int,
                    pad_to_multiple: int = 1
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad + L2-normalize + truncate token features for the given caption
    keys of an OPEN feature store — the packing convention every consumer
    shares. Returns (feats (N, Lq, Dq), mask).

    pad_to_multiple rounds the token axis up (extra positions zero-masked):
    the serving CLI packs to the query towers' 8-token grid; the eval
    keeps the exact max_desc_l."""
    first = np.asarray(h5[cap_ids[0]])
    q_dim = first.reshape(-1, first.shape[-1]).shape[-1]
    n = len(cap_ids)
    lq = -(-max_desc_l // pad_to_multiple) * pad_to_multiple
    feats = np.zeros((n, lq, q_dim), np.float32)
    mask = np.zeros((n, lq), np.float32)
    for i, cap_id in enumerate(cap_ids):
        raw = np.asarray(h5[cap_id][...], np.float32)
        raw = raw.reshape(-1, raw.shape[-1])  # squeeze leading singleton
        toks = l2_normalize_rows(raw)[:max_desc_l]
        feats[i, : len(toks)] = toks
        mask[i, : len(toks)] = 1.0
    return feats, mask


def open_features(path: str):
    """A read-only feature store keyed by caption id, used as a context
    manager with `key in store` and `store[key]`: an .npz archive, or else
    an HDF5 file (h5py)."""
    if path.endswith(".npz"):
        return np.load(path)
    import h5py

    return h5py.File(path, "r")


def _feature_file(path: str) -> str:
    """`path`, or its .npz twin when only that exists."""
    twin = os.path.splitext(path)[0] + ".npz"
    return twin if not os.path.exists(path) and os.path.exists(twin) \
        else path


def pack_query_set(
    cap_file: str,
    text_feat_path: str,
    max_desc_l: int = 30,
    teacher_text_feat_path: Optional[str] = None,
) -> PackedQueries:
    """Caption features (reference TxtDataSet4DLDKD, data_provider.py:315-357):
    RoBERTa token features L2-normalized + truncated to max_desc_l; with a
    teacher store, the raw CLIP sentence features too."""
    cap_ids, _, _, _ = load_captions(cap_file)
    with open_features(text_feat_path) as tf:
        feats, mask = pack_query_rows(tf, cap_ids, max_desc_l)
    teacher = None
    if teacher_text_feat_path is not None:
        with open_features(teacher_text_feat_path) as cf:
            teacher = np.stack([
                np.asarray(cf[_teacher_text_key(cf, c)][...],
                           np.float32).reshape(-1) for c in cap_ids])
    video_ids = [c.split("#")[0] for c in cap_ids]
    return PackedQueries(feats=feats, mask=mask, cap_ids=cap_ids,
                         video_ids=video_ids, teacher_feats=teacher)


# --------------------------------------------------------------------- #
# Standard path layout (reference train.py:261-292, eval.py:292-308)
# --------------------------------------------------------------------- #

def dataset_paths(root_path: str, collection: str, visual_feature: str) -> dict:
    base = os.path.join(root_path, collection)
    return {
        "visual_feat_dir": os.path.join(base, "FeatureData", visual_feature),
        "video2frames": os.path.join(base, "FeatureData", visual_feature,
                                     "video2frames.txt"),
        "teacher_vid_feat": _feature_file(os.path.join(
            base, "FeatureData",
            f"new_clip_vit_32_{collection}_vid_features.hdf5")),
        "text_feat": _feature_file(os.path.join(
            base, "TextData", f"roberta_{collection}_query_feat.hdf5")),
        "teacher_text_feat": _feature_file(os.path.join(
            base, "TextData", f"clip_ViT_B_32_{collection}_query_feat.hdf5")),
        "cap_file": {
            split: os.path.join(base, "TextData",
                                f"{collection}{split}.caption.txt")
            for split in ("train", "val", "test")
        },
    }
