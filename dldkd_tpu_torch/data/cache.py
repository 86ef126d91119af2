"""Content-keyed packed-dataset cache (the port's copy of
dldkd_tpu/data/cache.py: the same fingerprint, entry layout, environment
variables and pruning, so the two packages read each other's entries).

Ingestion (BigFile + three HDF5 files -> padded arrays, data/ingest.py) is
a per-launch cost the reference pays per EPOCH in DataLoader workers and we
pay once at startup. This cache makes run #2 startup near-zero: packed
arrays are stored as .npy files under a fingerprint of the source files'
(path, size, mtime_ns) plus the packing knobs (max_ctx_l, max_desc_l), and
loaded back with np.load(mmap_mode='r') — no BigFile/HDF5 touched on a hit,
and the OS page cache shares the mapping across processes.

Layout:  <cache_root>/<kind>-<fingerprint>/
           meta.json               fingerprint inputs + list fields
           <name>.npy              each array field
Writes build in a tmp dir and os.rename into place (atomic on one fs), so
a torn write can never be loaded. Entries are invalidated implicitly: any
source-file change moves the fingerprint. Cache root: $DLDKD_PACK_CACHE_DIR
or ~/.cache/dldkd_packed; disable with pack_cache=False / --no_pack_cache.

Eviction: every miss (= a new entry is about to be written) prunes the
least-recently-used entries of the SAME kind beyond
$DLDKD_PACK_CACHE_MAX_ENTRIES (default 8) — stale fingerprints from
source-file or knob churn cannot grow the cache unboundedly. Hits touch
the entry's meta.json mtime so recency tracks use, not creation.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from typing import Callable, Dict, List, Optional

import numpy as np

from dldkd_tpu_torch.data.ingest import PackedQueries, PackedVideos, TrainData

FORMAT_VERSION = 1


def cache_root(override: Optional[str] = None) -> str:
    return (override or os.environ.get("DLDKD_PACK_CACHE_DIR")
            or os.path.expanduser("~/.cache/dldkd_packed"))


def _bigfile_files(visual_feat_dir: str) -> List[str]:
    return [os.path.join(visual_feat_dir, f)
            for f in ("feature.bin", "shape.txt", "id.txt")]


def fingerprint(files: List[str], knobs: Dict) -> str:
    """Hash of source-file identity (path, size, mtime_ns) + packing knobs.
    Missing files hash as absent — the miss path will raise its own error."""
    h = hashlib.sha256()
    h.update(json.dumps({"v": FORMAT_VERSION, "knobs": knobs},
                        sort_keys=True).encode())
    for path in files:
        try:
            st = os.stat(path)
            sig = (path, st.st_size, st.st_mtime_ns)
        except OSError:
            sig = (path, -1, -1)
        h.update(repr(sig).encode())
    return h.hexdigest()[:24]


# --------------------------------------------------------------------- #
# (de)serialization of the packed containers
# --------------------------------------------------------------------- #

def _save_entry(entry_dir: str, arrays: Dict[str, Optional[np.ndarray]],
                lists: Dict, knobs: Dict) -> None:
    parent = os.path.dirname(entry_dir)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=parent, prefix=".build-")
    try:
        for name, arr in arrays.items():
            if arr is not None:
                np.save(os.path.join(tmp, f"{name}.npy"),
                        np.ascontiguousarray(arr))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"v": FORMAT_VERSION, "knobs": knobs,
                       "arrays": [k for k, v in arrays.items()
                                  if v is not None],
                       "lists": lists}, f)
        os.rename(tmp, entry_dir)
    except OSError:
        # lost the race to another process writing the same entry, or the
        # rename target appeared: the existing entry wins
        shutil.rmtree(tmp, ignore_errors=True)
        if not os.path.isdir(entry_dir):
            raise


def _load_entry(entry_dir: str):
    with open(os.path.join(entry_dir, "meta.json")) as f:
        meta = json.load(f)
    arrays = {name: np.load(os.path.join(entry_dir, f"{name}.npy"),
                            mmap_mode="r")
              for name in meta["arrays"]}
    return arrays, meta["lists"]


def _videos_fields(v: PackedVideos, prefix: str):
    return ({f"{prefix}feats": v.feats, f"{prefix}mask": v.mask,
             f"{prefix}teacher_feats": v.teacher_feats},
            {f"{prefix}ids": v.ids})


def _queries_fields(q: PackedQueries, prefix: str):
    return ({f"{prefix}feats": q.feats, f"{prefix}mask": q.mask,
             f"{prefix}teacher_feats": q.teacher_feats},
            {f"{prefix}cap_ids": q.cap_ids, f"{prefix}video_ids": q.video_ids})


def _videos_from(arrays, lists, prefix: str) -> PackedVideos:
    return PackedVideos(feats=arrays[f"{prefix}feats"],
                        mask=arrays[f"{prefix}mask"],
                        ids=list(lists[f"{prefix}ids"]),
                        teacher_feats=arrays.get(f"{prefix}teacher_feats"))


def _queries_from(arrays, lists, prefix: str) -> PackedQueries:
    return PackedQueries(feats=arrays[f"{prefix}feats"],
                         mask=arrays[f"{prefix}mask"],
                         cap_ids=list(lists[f"{prefix}cap_ids"]),
                         video_ids=list(lists[f"{prefix}video_ids"]),
                         teacher_feats=arrays.get(f"{prefix}teacher_feats"))


# --------------------------------------------------------------------- #
# cached packers (same signatures as the drivers need)
# --------------------------------------------------------------------- #

def max_entries_per_kind() -> int:
    try:
        return int(os.environ.get("DLDKD_PACK_CACHE_MAX_ENTRIES", "8"))
    except ValueError:
        return 8


def _prune_kind(root_dir: str, kind: str, keep: str) -> None:
    """LRU-evict entries of one kind beyond the budget (miss-time sweep).
    `keep` (the entry about to be written) never counts against others
    twice nor gets evicted itself. Entries still being built (tmp dirs
    prefixed '.') are ignored; racing removals are harmless (rmtree
    ignore_errors, and readers treat a vanished entry as a miss)."""
    budget = max_entries_per_kind()
    if budget <= 0:
        return
    try:
        names = os.listdir(root_dir)
    except OSError:
        return
    entries = []
    for name in names:
        if not name.startswith(f"{kind}-") or name == os.path.basename(keep):
            continue
        meta = os.path.join(root_dir, name, "meta.json")
        try:
            entries.append((os.stat(meta).st_mtime_ns, name))
        except OSError:
            continue
    # the new entry occupies one slot of the budget
    excess = len(entries) - (budget - 1)
    if excess > 0:
        for _, name in sorted(entries)[:excess]:
            shutil.rmtree(os.path.join(root_dir, name), ignore_errors=True)


def _cached(kind: str, files: List[str], knobs: Dict, root: Optional[str],
            build: Callable, save: Callable, load: Callable):
    entry = os.path.join(cache_root(root),
                         f"{kind}-{fingerprint(files, knobs)}")
    if os.path.isdir(entry):
        try:
            out = load(*_load_entry(entry))
            os.utime(os.path.join(entry, "meta.json"))  # LRU recency
            return out
        except (OSError, KeyError, json.JSONDecodeError):
            shutil.rmtree(entry, ignore_errors=True)  # corrupt: rebuild
    obj = build()
    arrays, lists = save(obj)
    _prune_kind(cache_root(root), kind, entry)
    _save_entry(entry, arrays, lists, knobs)
    return obj


def cached_train_pack(paths: Dict, max_ctx_l: int, max_desc_l: int,
                      cache_dir: Optional[str] = None) -> TrainData:
    """pack_train_dataset through the cache. paths: dataset_paths() dict."""
    from dldkd_tpu_torch.data import BigFile, read_dict
    from dldkd_tpu_torch.data.ingest import pack_train_dataset

    files = [paths["cap_file"]["train"], paths["video2frames"],
             paths["text_feat"], paths["teacher_vid_feat"],
             paths["teacher_text_feat"],
             *_bigfile_files(paths["visual_feat_dir"])]
    knobs = {"max_ctx_l": max_ctx_l, "max_desc_l": max_desc_l}

    def build() -> TrainData:
        vf = BigFile(paths["visual_feat_dir"])
        return pack_train_dataset(
            paths["cap_file"]["train"], vf, read_dict(paths["video2frames"]),
            paths["text_feat"], paths["teacher_vid_feat"],
            paths["teacher_text_feat"],
            max_ctx_l=max_ctx_l, max_desc_l=max_desc_l)

    def save(td: TrainData):
        arrays, lists = _videos_fields(td.videos, "videos_")
        qa, ql = _queries_fields(td.queries, "queries_")
        arrays.update(qa)
        lists.update(ql)
        arrays["cap_index_values"] = np.concatenate(td.vid_cap_index)
        arrays["cap_index_offsets"] = np.cumsum(
            [0] + [len(c) for c in td.vid_cap_index]).astype(np.int64)
        return arrays, lists

    def load(arrays, lists) -> TrainData:
        off = np.asarray(arrays["cap_index_offsets"])
        vals = np.asarray(arrays["cap_index_values"])
        index = [vals[off[i]:off[i + 1]] for i in range(len(off) - 1)]
        return TrainData(videos=_videos_from(arrays, lists, "videos_"),
                         queries=_queries_from(arrays, lists, "queries_"),
                         vid_cap_index=index)

    return _cached("train", files, knobs, cache_dir, build, save, load)


def cached_corpus_pack(paths: Dict, split: str, max_ctx_l: int,
                       cache_dir: Optional[str] = None) -> PackedVideos:
    """pack_video_corpus for one split's video list, through the cache."""
    from dldkd_tpu_torch.data import BigFile, read_dict
    from dldkd_tpu_torch.data.ingest import (pack_video_corpus,
                                             read_video_ids)

    files = [paths["cap_file"][split], paths["video2frames"],
             *_bigfile_files(paths["visual_feat_dir"])]
    knobs = {"max_ctx_l": max_ctx_l, "split": split}

    def build() -> PackedVideos:
        vf = BigFile(paths["visual_feat_dir"])
        return pack_video_corpus(read_video_ids(paths["cap_file"][split]),
                                 vf, read_dict(paths["video2frames"]),
                                 max_ctx_l=max_ctx_l)

    def save(v: PackedVideos):
        return _videos_fields(v, "videos_")

    def load(arrays, lists) -> PackedVideos:
        return _videos_from(arrays, lists, "videos_")

    return _cached("corpus", files, knobs, cache_dir, build, save, load)


def cached_query_pack(paths: Dict, split: str, max_desc_l: int,
                      cache_dir: Optional[str] = None) -> PackedQueries:
    """pack_query_set for one split, through the cache."""
    from dldkd_tpu_torch.data.ingest import pack_query_set

    files = [paths["cap_file"][split], paths["text_feat"]]
    knobs = {"max_desc_l": max_desc_l, "split": split}

    def build() -> PackedQueries:
        return pack_query_set(paths["cap_file"][split], paths["text_feat"],
                              max_desc_l=max_desc_l)

    def save(q: PackedQueries):
        return _queries_fields(q, "queries_")

    def load(arrays, lists) -> PackedQueries:
        return _queries_from(arrays, lists, "queries_")

    return _cached("queries", files, knobs, cache_dir, build, save, load)
