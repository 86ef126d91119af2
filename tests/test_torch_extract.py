"""The port's teacher extraction (`tools/extract_teacher.py`) against the
JAX package's tool on the same tiny CLIP model directory, captions and
frames: the same keys, features within 1e-5 (two-layer f32 towers at
matmul precision "highest", sums in another order; the preprocessing is
equal), and the `.npz` stores read back by the port's data layer."""

import json
import os
import sys

import h5py
import numpy as np
import pytest
import torch
from PIL import Image
from transformers import CLIPImageProcessor

from dldkd_tpu.tools import extract_teacher as jax_extract
from dldkd_tpu_torch.data.ingest import (dataset_paths, open_features,
                                         pack_train_dataset, read_dict,
                                         read_video_ids)
from dldkd_tpu_torch.data.bigfile import BigFile
from dldkd_tpu_torch.data.synthetic import generate_dataset
from dldkd_tpu_torch.models.clip import (ClipConfig, ClipModel,
                                         ClipTowerConfig, save_clip)
from dldkd_tpu_torch.tools import extract_teacher as port_extract

TOL = 1e-5
PROJ = 6


@pytest.fixture(autouse=True)
def _f32_products():
    prev = torch.get_float32_matmul_precision(), torch.get_num_threads()
    torch.set_float32_matmul_precision("highest")
    torch.set_num_threads(1)
    yield
    torch.set_float32_matmul_precision(prev[0])
    torch.set_num_threads(prev[1])


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A tiny CLIP in the JAX tool's model-directory layout: the real
    vocabulary and eos 2 (so the in-repo BPE's ids fit), two layers,
    image 32 in patches of 8, seeded weights, and a preprocessor config
    written by transformers."""
    d = str(tmp_path_factory.mktemp("clip"))
    small = dict(hidden_size=8, intermediate_size=16, num_hidden_layers=2,
                 num_attention_heads=2)
    cfg = ClipConfig(text=ClipTowerConfig(eos_token_id=2, **small),
                     vision=ClipTowerConfig(image_size=32, patch_size=8,
                                            **small),
                     projection_dim=PROJ)
    model = ClipModel(cfg).init_weights(torch.Generator().manual_seed(4),
                                        std=0.2)
    save_clip(model, d)
    CLIPImageProcessor(size={"shortest_edge": 32},
                       crop_size={"height": 32, "width": 32}
                       ).save_pretrained(d)
    return d


@pytest.fixture(scope="module")
def fns(model_dir):
    return (jax_extract.build_clip_fns(model_dir),
            port_extract.build_clip_fns(model_dir, device="cpu"))


def _store(path):
    if path.endswith(".npz"):
        with np.load(path) as f:
            return {k: f[k] for k in f.files}
    with h5py.File(path, "r") as f:
        return {k: np.asarray(f[k]) for k in f}


def _assert_stores_match(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL)


def test_query_features_match_jax(fns, tmp_path):
    captions = ["a man is talking to a woman", "IT'S raining &amp; cold",
                "café über 12 lazy dogs!!", "x " * 60, "日本語 😀", "a"]
    cap_file = tmp_path / "synthtrain.caption.txt"
    cap_file.write_text("".join(f"v{i // 2}#enc#{i % 2} {c}\n"
                                for i, c in enumerate(captions)))
    (jf, pf) = fns
    want_path = str(tmp_path / "jax.hdf5")
    assert jax_extract.extract_query_features(
        str(cap_file), want_path, jf["tokenize"], jf["encode_text"],
        bsz=4) == 6
    want = _store(want_path)
    assert np.abs(np.stack(list(want.values()))).max() > 0.1
    for fmt in ("npz", "hdf5"):
        out = str(tmp_path / "port" / "q.hdf5")
        n = port_extract.extract_query_features(
            str(cap_file), out, pf["tokenize"], pf["encode_text"], bsz=4,
            feature_format=fmt)
        assert n == 6
        path = port_extract.store_path(out, fmt)
        assert path.endswith("." + fmt)
        _assert_stores_match(_store(path), want)
    with open_features(str(tmp_path / "port" / "q.npz")) as f:
        assert f["v1#enc#1"].shape == (PROJ,)


def _write_frames(root):
    """Two .npy stacks (one upscaled, one tall) and one directory of PNG
    frames named so that only a numeric sort orders them."""
    rng = np.random.RandomState(5)
    os.makedirs(root)
    np.save(os.path.join(root, "vidA.npy"),
            rng.randint(0, 256, (5, 24, 40, 3), dtype=np.uint8))
    np.save(os.path.join(root, "vidB.npy"),
            rng.randint(0, 256, (9, 70, 48, 3), dtype=np.uint8))
    os.makedirs(os.path.join(root, "vidC"))
    for t in range(11):
        Image.fromarray(rng.randint(0, 256, (36, 52, 3), dtype=np.uint8)
                        ).save(os.path.join(root, "vidC", f"frame_{t}.png"))
    return ["vidA", "vidB", "vidC"]


@pytest.mark.parametrize("max_frames", [0, 4])
def test_video_features_match_jax(fns, tmp_path, max_frames):
    root = str(tmp_path / "frames")
    vids = _write_frames(root)
    (jf, pf) = fns
    want_path = str(tmp_path / "jax.hdf5")
    assert jax_extract.extract_video_features(
        vids, root, want_path, jf["preprocess"], jf["encode_image"], bsz=4,
        max_frames=max_frames) == 3
    want = _store(want_path)
    out = str(tmp_path / "port.hdf5")
    assert port_extract.extract_video_features(
        vids, root, out, pf["preprocess"], pf["encode_image"], bsz=4,
        max_frames=max_frames, feature_format="npz") == 3
    got = _store(port_extract.store_path(out, "npz"))
    _assert_stores_match(got, want)
    assert got["vidC"].shape == ((max_frames or 11), PROJ)
    # the pixel values themselves: bitwise those of the JAX tool's
    # CLIPImageProcessor, through the preprocessor config it wrote
    frames = np.load(os.path.join(root, "vidB.npy"))
    np.testing.assert_array_equal(
        pf["preprocess"](frames)["pixel_values"].numpy(),
        jf["preprocess"](frames)["pixel_values"])


def _cli(argv):
    return port_extract.main(argv)


def test_cli_writes_the_stores_the_trainer_reads(model_dir, tmp_path):
    """Both modes through main() with --feature_format npz, then the
    trainer's packer on the extracted teacher stores."""
    root = str(tmp_path / "data")
    generate_dataset(root, n_videos={"train": 5, "val": 2, "test": 2},
                     teacher_frames_range=(3, 4), feature_format="npz")
    base = os.path.join(root, "synthetic")
    cap_file = os.path.join(base, "TextData", "synthetictrain.caption.txt")
    frames = str(tmp_path / "frames")
    os.makedirs(frames)
    rng = np.random.RandomState(6)
    train_vids = read_video_ids(cap_file)
    for i, vid in enumerate(train_vids):
        np.save(os.path.join(frames, f"{vid}.npy"),
                rng.randint(0, 256, (3 + i, 30, 40, 3), dtype=np.uint8))
    common = ["--collection", "synthetic", "--root_path", root,
              "--clip_model", model_dir, "--feature_format", "npz",
              "--torch_device", "cpu", "--bsz", "4"]
    n_caps = _cli(["--mode", "text"] + common)
    assert _cli(["--mode", "video", "--frames_root", frames] + common) == 5
    paths = dataset_paths(root, "synthetic", "i3d")
    assert paths["teacher_vid_feat"].endswith(".npz")
    data = pack_train_dataset(
        cap_file, BigFile(paths["visual_feat_dir"]),
        read_dict(paths["video2frames"]), paths["text_feat"],
        paths["teacher_vid_feat"], paths["teacher_text_feat"],
        max_ctx_l=8, max_desc_l=6)
    assert data.queries.teacher_feats.shape == (n_caps, PROJ)
    assert data.videos.teacher_feats.shape == (5, 8, PROJ)
    assert np.isfinite(data.videos.teacher_feats).all()


def test_cli_hdf5_without_h5py_raises(model_dir, tmp_path, monkeypatch):
    """The format is the caller's choice: no quiet switch to .npz."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="feature_format npz"):
        _cli(["--mode", "text", "--collection", "c", "--root_path",
              str(tmp_path), "--clip_model", model_dir, "--torch_device",
              "cpu"])
    assert not os.listdir(tmp_path)


def test_cli_runs_on_cuda_unless_told(model_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _cli(["--mode", "text", "--collection", "c", "--root_path",
              str(tmp_path), "--clip_model", model_dir,
              "--feature_format", "npz"])


def test_model_dir_reads_without_transformers(model_dir):
    """The directory's three files, and nothing else, carry the model."""
    assert sorted(os.listdir(model_dir)) == [
        "config.json", "flax_model.msgpack", "preprocessor_config.json"]
    with open(os.path.join(model_dir, "config.json")) as f:
        assert json.load(f)["text_config"]["eos_token_id"] == 2
