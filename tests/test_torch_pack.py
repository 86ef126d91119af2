"""The port's native corpus packer and pack cache against the JAX package's,
on the CPU (ROADMAP A4b; fault C2).

- `dldkd_tpu_torch/csrc/host/dldkd_native.cpp` is byte for byte
  `native/dldkd_native.cpp`, built by the port into its own build
  directory.
- The port's corpus and training packers on the native path are bitwise
  the JAX package's on its native path (same C++, same arguments), so the
  one-ulp gap of C2 (native against numpy) is gone between the packages;
  the numpy path ($DLDKD_NO_NATIVE=1, a float16 BigFile) stays within the
  JAX package's tolerance of the native one (tests/test_native.py:83,
  rtol 1e-5, atol 1e-6: each normalizes by its own norm, f64 sums and a
  reciprocal in C++, numpy's f32 norm and a divide; a few f32 ulps), and
  the packer's counter tells them apart.
- The pack cache: the JAX package's fingerprints and entry layout (an
  entry written by either package is a hit for the other, with equal
  arrays), a hit equals a fresh pack, LRU pruning, and --no_pack_cache
  (cfg.data.pack_cache False) bypasses it in infer and train.
"""

import os
from pathlib import Path

import numpy as np
import pytest

from dldkd_tpu.data import cache as jax_cache
from dldkd_tpu.data import ingest as jax_ingest
from dldkd_tpu.data import native as jax_native
from dldkd_tpu.data.bigfile import BigFile as JaxBigFile
from dldkd_tpu.data.synthetic import generate_dataset as jax_generate
from dldkd_tpu_torch import infer, train
from dldkd_tpu_torch.config import parse_args
from dldkd_tpu_torch.data import (BigFile, BigFile16, cache, native,
                                  pack_train_dataset, pack_video_corpus,
                                  read_dict)
from dldkd_tpu_torch.data.ingest import dataset_paths, read_video_ids

REPO = Path(__file__).resolve().parents[1]
GEN = dict(n_videos={"train": 9, "val": 4, "test": 5}, frames_range=(6, 40),
           teacher_frames_range=(4, 30), tokens_range=(3, 9),
           d_student=12, d_query=10, d_teacher=6, seed=11)
MAX_CTX, MAX_DESC = 16, 7


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    base = tmp_path_factory.mktemp("pack")
    jax_generate(str(base), **GEN)
    return str(base)


@pytest.fixture
def native_on(monkeypatch):
    """Both packages on their native packers, the JAX one re-probed."""
    monkeypatch.delenv("DLDKD_NO_NATIVE", raising=False)
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_tried", False)
    if native.load() is None or jax_native.load() is None:
        pytest.skip("no g++ to build the native packer")


def _paths(root):
    return dataset_paths(root, "synthetic", "i3d")


def _port_corpus(root, split="test"):
    p = _paths(root)
    return pack_video_corpus(read_video_ids(p["cap_file"][split]),
                             BigFile(p["visual_feat_dir"]),
                             read_dict(p["video2frames"]), max_ctx_l=MAX_CTX)


def _jax_corpus(root, split="test"):
    p = jax_ingest.dataset_paths(root, "synthetic", "i3d")
    return jax_ingest.pack_video_corpus(
        jax_ingest.read_video_ids(p["cap_file"][split]),
        JaxBigFile(p["visual_feat_dir"]),
        jax_ingest.read_dict(p["video2frames"]), max_ctx_l=MAX_CTX)


def test_cpp_source_is_the_jax_packages():
    assert native.SRC.read_bytes() \
        == (REPO / "native" / "dldkd_native.cpp").read_bytes()
    assert native.SRC.parent.parent.name == "csrc"


def test_native_corpus_packer_bitwise_jax_native(root, native_on):
    before = native.LAUNCHES["pack_corpus"]
    got = _port_corpus(root)
    assert native.LAUNCHES["pack_corpus"] == before + 1
    assert native.library_path().exists()
    assert native.library_path().parent \
        == (REPO / "dldkd_tpu_torch" / "csrc" / "_build").resolve()
    want = _jax_corpus(root)
    np.testing.assert_array_equal(got.feats, want.feats)
    np.testing.assert_array_equal(got.mask, want.mask)
    assert got.ids == want.ids
    # the numpy path (C2): within a few f32 ulps of the native one, and the
    # counter does not move
    os.environ["DLDKD_NO_NATIVE"] = "1"
    try:
        slow = _port_corpus(root)
    finally:
        del os.environ["DLDKD_NO_NATIVE"]
    assert native.LAUNCHES["pack_corpus"] == before + 1
    np.testing.assert_array_equal(slow.mask, got.mask)
    np.testing.assert_allclose(slow.feats, got.feats, rtol=1e-5, atol=1e-6)


def test_native_train_packer_bitwise_jax_native(root, native_on):
    p = _paths(root)
    before = native.LAUNCHES["pack_corpus"]
    got = pack_train_dataset(
        p["cap_file"]["train"], BigFile(p["visual_feat_dir"]),
        read_dict(p["video2frames"]), p["text_feat"], p["teacher_vid_feat"],
        p["teacher_text_feat"], max_ctx_l=MAX_CTX, max_desc_l=MAX_DESC)
    assert native.LAUNCHES["pack_corpus"] == before + 1
    jp = jax_ingest.dataset_paths(root, "synthetic", "i3d")
    want = jax_ingest.pack_train_dataset(
        jp["cap_file"]["train"], JaxBigFile(jp["visual_feat_dir"]),
        jax_ingest.read_dict(jp["video2frames"]), jp["text_feat"],
        jp["teacher_vid_feat"], jp["teacher_text_feat"], max_ctx_l=MAX_CTX,
        max_desc_l=MAX_DESC)
    for a, b in ((got.videos.feats, want.videos.feats),
                 (got.videos.mask, want.videos.mask),
                 (got.videos.teacher_feats, want.videos.teacher_feats),
                 (got.queries.feats, want.queries.feats)):
        np.testing.assert_array_equal(a, b)
    # both resampling directions and ragged masks are exercised
    lengths = got.videos.mask.sum(1)
    assert lengths.max() == MAX_CTX and lengths.min() < MAX_CTX


def test_float16_bigfile_takes_the_numpy_path(root, tmp_path, native_on):
    src = Path(_paths(root)["visual_feat_dir"])
    dst = tmp_path / "bf16"
    dst.mkdir()
    for name in ("shape.txt", "id.txt", "video2frames.txt"):
        (dst / name).write_bytes((src / name).read_bytes())
    rows = np.fromfile(src / "feature.bin", np.float32)
    rows.astype(np.float16).tofile(dst / "feature.bin")
    p = _paths(root)
    before = native.LAUNCHES["pack_corpus"]
    got = pack_video_corpus(read_video_ids(p["cap_file"]["test"]),
                            BigFile16(str(dst)),
                            read_dict(p["video2frames"]), max_ctx_l=MAX_CTX)
    assert native.LAUNCHES["pack_corpus"] == before
    np.testing.assert_allclose(got.feats, _port_corpus(root).feats,
                               atol=2e-3)


def test_cache_entries_cross_packages_and_hit_equals_fresh(root, tmp_path,
                                                           monkeypatch):
    monkeypatch.setenv("DLDKD_PACK_CACHE_DIR", str(tmp_path / "c"))
    p = _paths(root)
    assert cache.fingerprint([p["video2frames"]], {"a": 1}) \
        == jax_cache.fingerprint([p["video2frames"]], {"a": 1})
    fresh = _port_corpus(root, "val")
    miss = cache.cached_corpus_pack(p, "val", MAX_CTX)
    hit = cache.cached_corpus_pack(p, "val", MAX_CTX)
    assert isinstance(hit.feats, np.memmap)
    for got in (miss, hit):
        np.testing.assert_array_equal(got.feats, fresh.feats)
        np.testing.assert_array_equal(got.mask, fresh.mask)
        assert got.ids == fresh.ids
    # the JAX package finds the port's entry (no new one), and the other
    # way round for queries and the train split
    entries = sorted(os.listdir(tmp_path / "c"))
    jhit = jax_cache.cached_corpus_pack(p, "val", MAX_CTX)
    assert sorted(os.listdir(tmp_path / "c")) == entries
    np.testing.assert_array_equal(jhit.feats, fresh.feats)
    jq = jax_cache.cached_query_pack(p, "val", MAX_DESC)
    q = cache.cached_query_pack(p, "val", MAX_DESC)
    np.testing.assert_array_equal(q.feats, jq.feats)
    assert (q.cap_ids, q.video_ids) == (jq.cap_ids, jq.video_ids)
    jt = jax_cache.cached_train_pack(p, MAX_CTX, MAX_DESC)
    n = len(os.listdir(tmp_path / "c"))
    t = cache.cached_train_pack(p, MAX_CTX, MAX_DESC)
    assert len(os.listdir(tmp_path / "c")) == n
    np.testing.assert_array_equal(t.videos.teacher_feats,
                                  jt.videos.teacher_feats)
    for a, b in zip(t.vid_cap_index, jt.vid_cap_index):
        np.testing.assert_array_equal(a, b)


def test_cache_prunes_least_recently_used(root, tmp_path, monkeypatch):
    monkeypatch.setenv("DLDKD_PACK_CACHE_DIR", str(tmp_path / "c"))
    monkeypatch.setenv("DLDKD_PACK_CACHE_MAX_ENTRIES", "2")
    p = _paths(root)
    for l_ctx in (4, 5, 6):
        cache.cached_corpus_pack(p, "test", l_ctx)
    kept = sorted(os.listdir(tmp_path / "c"))
    assert len(kept) == 2 and all(k.startswith("corpus-") for k in kept)


def test_no_pack_cache_bypasses_the_cache(root, tmp_path, monkeypatch):
    """infer.pack_split and train.build_model_and_data read through the
    cache by default and not at all with --no_pack_cache."""
    monkeypatch.setenv("DLDKD_PACK_CACHE_DIR", str(tmp_path / "c"))
    flags = ["--root_path", root, "--collection", "synthetic",
             "--visual_feature", "i3d", "--q_feat_size", "10",
             "--max_ctx_l", str(MAX_CTX), "--max_desc_l", str(MAX_DESC),
             "--double_branch", "--results_root", str(tmp_path / "r")]
    for extra, want_entries in (["--no_pack_cache"], 0), ([], 3):
        cfg = parse_args(flags + extra, finalize=False)
        mcfg, td, val_v, val_q, _ = train.build_model_and_data(cfg)
        entries = (os.listdir(tmp_path / "c") if (tmp_path / "c").exists()
                   else [])
        assert len(entries) == want_entries
        assert mcfg.visual_input_size == GEN["d_student"]
        videos, queries = infer.pack_split(cfg, "test", mcfg)
        np.testing.assert_array_equal(videos.feats,
                                      _port_corpus(root).feats)
        assert len(queries) > len(videos)
    assert len(os.listdir(tmp_path / "c")) == 5   # train, val x2, test x2
