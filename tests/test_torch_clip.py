"""The port's CLIP (`models/clip.py`) and frame preprocessing
(`tools/clip_preprocess.py`) against transformers' FlaxCLIPModel and
CLIPImageProcessor, which the JAX package's extraction tool runs.

Tolerances: features within 1e-5 abs of Flax's (two-layer towers in f32
at matmul precision "highest" on both sides, sums in another order);
the resize bitwise equal to PIL's bicubic (exact integer arithmetic);
`pixel_values` within 1e-6 of CLIPImageProcessor's (the same float32
operations after the resize).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image
from transformers import CLIPConfig, CLIPImageProcessor, FlaxCLIPModel

from dldkd_tpu_torch.checkpoint import read_msgpack
from dldkd_tpu_torch.convert import (clip_params_to_flax,
                                     clip_state_dict_from_flax)
from dldkd_tpu_torch.models.clip import (ClipConfig, ClipModel, load_clip,
                                         save_clip)
from dldkd_tpu_torch.tools.clip_preprocess import (ClipPreprocessor,
                                                   PreprocessConfig,
                                                   read_preprocess_config,
                                                   resize_shape)

TOL = 1e-5


@pytest.fixture(autouse=True)
def _f32_products():
    prev = torch.get_float32_matmul_precision(), torch.get_num_threads()
    torch.set_float32_matmul_precision("highest")
    torch.set_num_threads(1)
    yield
    torch.set_float32_matmul_precision(prev[0])
    torch.set_num_threads(prev[1])


def _tiny_config(eos: int, image: int = 32) -> CLIPConfig:
    """Two layers per tower (tests/test_extract.py's tiny config, deeper),
    image 32 in patches of 8."""
    return CLIPConfig(
        text_config={"hidden_size": 8, "intermediate_size": 16,
                     "num_hidden_layers": 2, "num_attention_heads": 2,
                     "max_position_embeddings": 16, "vocab_size": 99,
                     "eos_token_id": eos},
        vision_config={"hidden_size": 8, "intermediate_size": 16,
                       "num_hidden_layers": 2, "num_attention_heads": 2,
                       "image_size": image, "patch_size": 8},
        projection_dim=6)


def _flax_with_port_weights(cfg: CLIPConfig, seed: int):
    """A FlaxCLIPModel carrying the port's seeded weights (std 0.2, so
    the features are far from 0), and the port's model."""
    flax_model = FlaxCLIPModel(cfg, seed=0)
    port = ClipModel(ClipConfig.from_dict(cfg.to_dict()))
    port.init_weights(torch.Generator().manual_seed(seed), std=0.2)
    flax_model.params = jax.tree_util.tree_map(
        np.asarray, clip_params_to_flax(port.state_dict()))
    return flax_model, port


def _text_inputs(eos: int):
    """ids of a vocabulary of 99 (an eos outside it appears nowhere)."""
    rng = np.random.RandomState(1)
    ids = rng.randint(3, 99, (6, 16)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[4, 10:] = 0                                 # no eos at all
    if eos < 99:
        ids[ids == eos] = 7
        ids[0, 5], ids[0, 6:], mask[0, 6:] = eos, 1, 0   # padded after eos
        ids[1, 3], ids[1, 9] = eos, eos              # two: the first pools
        ids[2, 15] = eos                             # last position
        ids[3, 0] = eos
    return ids, mask


@pytest.mark.parametrize("eos", [2, 5, 49407])
def test_text_features_match_flax(tmp_path, eos):
    """eos 2 pools at the argmax id (the openai configs' legacy branch);
    any other eos at its first position, or position 0 without one."""
    flax_model, _ = _flax_with_port_weights(_tiny_config(eos), seed=eos)
    flax_model.save_pretrained(tmp_path)
    port = load_clip(str(tmp_path), "cpu")
    ids, mask = _text_inputs(eos)
    want = np.asarray(flax_model.get_text_features(input_ids=ids,
                                                   attention_mask=mask))
    with torch.no_grad():
        got = port.get_text_features(torch.from_numpy(ids),
                                     torch.from_numpy(mask)).numpy()
    assert got.shape == (6, 6) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("image,size", [(32, 32), (32, 37)])
def test_image_features_match_flax(tmp_path, image, size):
    """NCHW pixels; a side that is not a multiple of the patch loses its
    remainder (Flax's VALID convolution)."""
    flax_model, _ = _flax_with_port_weights(_tiny_config(2, image), seed=9)
    flax_model.save_pretrained(tmp_path)
    port = load_clip(str(tmp_path), "cpu")
    px = np.random.RandomState(2).randn(3, 3, size, size).astype(np.float32)
    want = np.asarray(flax_model.get_image_features(pixel_values=px))
    with torch.no_grad():
        got = port.get_image_features(torch.from_numpy(px)).numpy()
    assert got.shape == (3, 6) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_weights_round_trip_both_ways(tmp_path):
    """Flax tree -> state dict -> Flax tree is the identity, and a
    directory `save_clip` writes loads in FlaxCLIPModel with the same
    features."""
    flax_model = FlaxCLIPModel(_tiny_config(5), seed=3)
    flax_model.save_pretrained(tmp_path / "flax")
    tree = read_msgpack(str(tmp_path / "flax" / "flax_model.msgpack"))
    back = clip_params_to_flax(clip_state_dict_from_flax(tree))
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)

    port = load_clip(str(tmp_path / "flax"), "cpu")
    save_clip(port, str(tmp_path / "port"))
    reloaded = FlaxCLIPModel.from_pretrained(str(tmp_path / "port"))
    ids, mask = _text_inputs(5)
    np.testing.assert_array_equal(
        np.asarray(reloaded.get_text_features(input_ids=ids,
                                              attention_mask=mask)),
        np.asarray(flax_model.get_text_features(input_ids=ids,
                                                attention_mask=mask)))
    with open(tmp_path / "port" / "config.json") as f:
        assert ClipConfig.from_dict(json.load(f)) == port.cfg


FRAME_SIZES = [(240, 320), (360, 640), (100, 150), (500, 333), (224, 224),
               (37, 29)]


def _frames(h, w, seed=0):
    """Noise and a smooth pattern (the two stress different weights)."""
    rng = np.random.RandomState(seed)
    fr = rng.randint(0, 256, (2, h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    fr[1] = ((np.sin(yy / 7.0) + np.cos(xx / 5.0)) * 60 + 128
             ).astype(np.uint8)[..., None]
    return fr


@pytest.mark.parametrize("h,w", FRAME_SIZES)
@pytest.mark.parametrize("edge", [224, 57])
def test_resize_bitwise_equal_to_pil(h, w, edge):
    """The shortest-edge resize alone (no crop, no rescale), up and down,
    against PIL's bicubic on the same frames."""
    fr = _frames(h, w)
    oh, ow = resize_shape(h, w, edge)
    want = np.stack([np.asarray(Image.fromarray(f).resize(
        (ow, oh), Image.BICUBIC)) for f in fr])
    cfg = PreprocessConfig(shortest_edge=edge, do_center_crop=False,
                           do_rescale=False, do_normalize=False)
    got = ClipPreprocessor(cfg, "cpu").resize_crop(fr)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("h,w", FRAME_SIZES)
@pytest.mark.parametrize("edge,crop", [(224, (224, 224)), (32, (32, 24))])
def test_pixel_values_match_clip_image_processor(tmp_path, h, w, edge, crop):
    """Through a preprocessor_config.json transformers writes: the
    pixel_values of CLIPImageProcessor (PIL resize) within 1e-6."""
    proc = CLIPImageProcessor(size={"shortest_edge": edge},
                              crop_size={"height": crop[0],
                                         "width": crop[1]})
    proc.save_pretrained(tmp_path)
    cfg = read_preprocess_config(str(tmp_path))
    assert cfg.shortest_edge == edge and cfg.crop_size == crop
    fr = _frames(h, w, seed=1)
    want = proc(images=list(fr), return_tensors="np")["pixel_values"]
    got = ClipPreprocessor(cfg, "cpu")(fr).numpy()
    assert got.shape == want.shape == (2, 3) + crop
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_preprocess_config_written_by_the_port_reads_in_transformers(
        tmp_path):
    cfg = PreprocessConfig(shortest_edge=48, crop_size=(40, 44))
    with open(os.path.join(tmp_path, "preprocessor_config.json"), "w") as f:
        json.dump(cfg.to_dict(), f)
    proc = CLIPImageProcessor.from_pretrained(str(tmp_path))
    fr = _frames(90, 120, seed=2)
    np.testing.assert_allclose(
        ClipPreprocessor(cfg, "cpu")(fr).numpy(),
        proc(images=list(fr), return_tensors="np")["pixel_values"],
        rtol=0, atol=1e-6)
    # the older int form of size and crop_size
    assert PreprocessConfig.from_dict({"size": 224, "crop_size": 224}) \
        == PreprocessConfig()
    with pytest.raises(ValueError, match="bicubic"):
        PreprocessConfig.from_dict({"resample": 2})
