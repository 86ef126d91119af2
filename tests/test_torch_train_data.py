"""The port's training data against the JAX package's: the packed train
split (`pack_train_dataset`) from HDF5 and from .npz stores, and the
loader's batches over three epochs, with and without a recorded epoch
order. Both packages are pinned to their numpy packers (DLDKD_NO_NATIVE),
so everything must be bitwise equal (tests/test_torch_pack.py holds the
two native packers against each other)."""

import numpy as np
import pytest
import torch

from dldkd_tpu.data import ingest as jax_ingest
from dldkd_tpu.data import native as jax_native
from dldkd_tpu.data.bigfile import BigFile as JaxBigFile
from dldkd_tpu.data.pipeline import TrainLoader as JaxTrainLoader
from dldkd_tpu.data.synthetic import generate_dataset as jax_generate
from dldkd_tpu_torch.data import (BigFile, TrainLoader, dataset_paths,
                                  device_prefetch, pack_train_dataset,
                                  read_dict)
from dldkd_tpu_torch.data.synthetic import generate_dataset

GEN = dict(n_videos={"train": 9, "val": 3}, frames_range=(6, 40),
           teacher_frames_range=(4, 30), tokens_range=(3, 9),
           d_student=12, d_query=10, d_teacher=6, seed=11)
MAX_CTX, MAX_DESC = 16, 7


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("train_data")
    jax_generate(str(base / "hdf5"), **GEN)
    generate_dataset(str(base / "npz"), feature_format="npz", **GEN)
    return {"hdf5": str(base / "hdf5"), "npz": str(base / "npz")}


def _port_pack(root):
    p = dataset_paths(root, "synthetic", "i3d")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DLDKD_NO_NATIVE", "1")   # the port's numpy packer
        return pack_train_dataset(
            p["cap_file"]["train"], BigFile(p["visual_feat_dir"]),
            read_dict(p["video2frames"]), p["text_feat"],
            p["teacher_vid_feat"], p["teacher_text_feat"], max_ctx_l=MAX_CTX,
            max_desc_l=MAX_DESC)


@pytest.fixture(scope="module")
def jax_data(roots):
    mp = pytest.MonkeyPatch()
    # the JAX package's numpy packer (its native one is an f32 ulp away)
    mp.setenv("DLDKD_NO_NATIVE", "1")
    mp.setattr(jax_native, "_lib", None)
    mp.setattr(jax_native, "_tried", False)
    try:
        p = jax_ingest.dataset_paths(roots["hdf5"], "synthetic", "i3d")
        return jax_ingest.pack_train_dataset(
            p["cap_file"]["train"], JaxBigFile(p["visual_feat_dir"]),
            jax_ingest.read_dict(p["video2frames"]), p["text_feat"],
            p["teacher_vid_feat"], p["teacher_text_feat"],
            max_ctx_l=MAX_CTX, max_desc_l=MAX_DESC)
    finally:
        mp.undo()


@pytest.mark.parametrize("store", ["hdf5", "npz"])
def test_pack_train_dataset_matches_jax(roots, jax_data, store):
    ours = _port_pack(roots[store])
    for a, b in ((ours.videos.feats, jax_data.videos.feats),
                 (ours.videos.mask, jax_data.videos.mask),
                 (ours.videos.teacher_feats, jax_data.videos.teacher_feats),
                 (ours.queries.feats, jax_data.queries.feats),
                 (ours.queries.mask, jax_data.queries.mask),
                 (ours.queries.teacher_feats, jax_data.queries.teacher_feats)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert ours.videos.ids == jax_data.videos.ids
    assert ours.queries.cap_ids == jax_data.queries.cap_ids
    assert len(ours.vid_cap_index) == len(jax_data.vid_cap_index)
    for a, b in zip(ours.vid_cap_index, jax_data.vid_cap_index):
        np.testing.assert_array_equal(a, b)
    # both resampling directions and ragged masks are exercised
    lengths = ours.videos.mask.sum(1)
    assert lengths.max() == MAX_CTX and lengths.min() < MAX_CTX


@pytest.mark.parametrize("recorded", [False, True])
def test_loader_batches_bitwise(roots, jax_data, recorded):
    ours = _port_pack(roots["hdf5"])
    order = None
    if recorded:
        rng = np.random.RandomState(5)
        order = [[ours.videos.ids[i] for i in rng.permutation(len(ours.videos))]
                 for _ in range(3)]
    kw = dict(bsz=4, seed=3, query_pad_multiple=8, epoch_order=order)
    mine, theirs = TrainLoader(ours, **kw), JaxTrainLoader(jax_data, **kw)
    assert mine.steps_per_epoch() == theirs.steps_per_epoch() == 3
    for epoch in range(3):
        batches = list(zip(mine.epoch(epoch), theirs.epoch(epoch),
                           strict=True))
        assert len(batches) == 3
        for a, b in batches:
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            labels = a["text_labels"]
            n_valid = int((labels >= 0).sum())
            assert (labels[n_valid:] == -1).all() and len(labels) % 8 == 0


def test_device_prefetch_on_cpu(roots):
    data = _port_pack(roots["npz"])
    loader = TrainLoader(data, bsz=4, seed=1, query_pad_multiple=8)
    host = list(loader.epoch(0))
    got = list(device_prefetch(loader.epoch(0), "cpu"))
    assert len(got) == len(host)
    for a, b in zip(got, host):
        for k in b:
            assert isinstance(a[k], torch.Tensor) and a[k].device.type == "cpu"
            np.testing.assert_array_equal(a[k].numpy(), b[k])


def test_device_prefetch_surfaces_producer_errors():
    def batches():
        yield {"x": np.zeros(2, np.float32)}
        raise RuntimeError("packer failed")

    it = device_prefetch(batches(), "cpu")
    next(it)
    with pytest.raises(RuntimeError, match="packer failed"):
        next(it)
