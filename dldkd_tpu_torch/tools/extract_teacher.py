"""Offline teacher (CLIP) feature extraction (the port of
dldkd_tpu/tools/extract_teacher.py).

Runs CLIP over every caption and over sampled video frames and writes the
two stores the trainer reads:

  TextData/clip_ViT_B_32_{collection}_query_feat.hdf5   cap_id -> (Dt,)
  FeatureData/new_clip_vit_32_{collection}_vid_features.hdf5
                                                        video_id -> (T, Dt)

or, with `--feature_format npz`, their `.npz` twins with the same keys
(what `data.ingest.open_features` reads where h5py is absent). The format
is the caller's choice: asking for hdf5 without h5py raises.

The model is `models/clip.py` on the card (`--torch_device cuda`, the
default; without a GPU that raises unless `--torch_device cpu`), loaded
from a local model directory in the layout `FlaxCLIPModel.from_pretrained`
reads: `config.json`, `flax_model.msgpack` and `preprocessor_config.json`.
Nothing is downloaded and transformers is not needed, except for
`--hf_tokenizer`, which tokenizes with the directory's HF tokenizer
instead of the in-repo CLIP BPE (`tools/clip_tokenizer.py`). Frames are
preprocessed on the device (`tools/clip_preprocess.py`, PIL's bicubic
bit for bit).

Video input is either a per-video directory of frame images
(frames_root/<video_id>/*.jpg, decoded with PIL, imported only then) or a
preextracted <video_id>.npy uint8 stack (T, H, W, 3).

The compute core is injected as callables (tokenize_fn / encode_text_fn,
preprocess_fn / encode_image_fn), so the loops run with any encoder;
`build_clip_fns` wires the CLIP of a model directory.

Usage: python -m dldkd_tpu_torch.tools.extract_teacher --mode text|video
           --collection C --root_path R --clip_model DIR
           [--frames_root DIR] [--split train] [--bsz 256]
           [--max_frames 0] [--hf_tokenizer] [--feature_format hdf5|npz]
           [--torch_device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import re
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from dldkd_tpu_torch.data.ingest import load_captions, read_video_ids
from dldkd_tpu_torch.data.synthetic import _NpzWriter

FEATURE_FORMATS = ("hdf5", "npz")


def _batched(seq: Sequence, bsz: int):
    for i in range(0, len(seq), bsz):
        yield seq[i:i + bsz]


def store_path(path: str, feature_format: str) -> str:
    """Where a store named `path` (.hdf5) is written in `feature_format`."""
    return path if feature_format == "hdf5" else \
        os.path.splitext(path)[0] + ".npz"


def _store_writer(feature_format: str) -> Callable[[str], object]:
    """path -> a writable store with `create_dataset(key, data)`, used as
    a context manager. hdf5 needs h5py and raises without it."""
    if feature_format not in FEATURE_FORMATS:
        raise ValueError(f"feature_format {feature_format!r}: use one of "
                         f"{FEATURE_FORMATS}")
    if feature_format == "hdf5":
        try:
            import h5py
        except ImportError as e:
            raise ImportError("--feature_format hdf5 needs h5py, which is "
                              "not installed; pass --feature_format npz "
                              "to write the .npz twin") from e
        return lambda path: h5py.File(path, "w")
    return _NpzWriter


def extract_query_features(
    cap_file: str,
    out_path: str,
    tokenize_fn: Callable[[List[str]], dict],
    encode_text_fn: Callable[[dict], np.ndarray],
    bsz: int = 256,
    feature_format: str = "hdf5",
) -> int:
    """Write cap_id -> CLIP sentence embedding to the store `out_path`
    names (see `store_path`).

    tokenize_fn: captions -> model inputs (dict of arrays, padded).
    encode_text_fn: model inputs -> (B, Dt).
    Returns the number of captions written.
    """
    open_store = _store_writer(feature_format)
    out_path = store_path(out_path, feature_format)
    cap_ids, captions, _, _ = load_captions(cap_file)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    n = 0
    with open_store(out_path) as f:
        for chunk in _batched(cap_ids, bsz):
            feats = np.asarray(
                encode_text_fn(tokenize_fn([captions[c] for c in chunk])),
                np.float32)
            for cap_id, vec in zip(chunk, feats):
                f.create_dataset(cap_id, data=vec)
                n += 1
    return n


def iter_video_frames(
    video_ids: Iterable[str],
    frames_root: str,
    max_frames: int = 0,
) -> Iterable[Tuple[str, np.ndarray]]:
    """Yield (video_id, (T, H, W, 3) uint8) from frame-image dirs or .npy
    stacks; with max_frames, T is cut to that many evenly spaced frames."""
    for vid in video_ids:
        npy = os.path.join(frames_root, f"{vid}.npy")
        d = os.path.join(frames_root, vid)
        if os.path.exists(npy):
            frames = np.load(npy)
        elif os.path.isdir(d):
            from PIL import Image

            exts = (".jpg", ".jpeg", ".png", ".bmp", ".webp")
            names = [n for n in os.listdir(d) if n.lower().endswith(exts)]
            # natural-numeric order: frame_2 before frame_10
            names.sort(key=lambda n: [int(t) if t.isdigit() else t
                                      for t in re.split(r"(\d+)", n)])
            imgs = [np.asarray(Image.open(os.path.join(d, n)).convert("RGB"))
                    for n in names]
            if not imgs:
                continue
            frames = np.stack(imgs)
        else:
            raise FileNotFoundError(f"no frames for {vid} under {frames_root}")
        if max_frames and frames.shape[0] > max_frames:
            idx = np.linspace(0, frames.shape[0] - 1, max_frames).astype(int)
            frames = frames[idx]
        yield vid, frames.astype(np.uint8)


def extract_video_features(
    video_ids: Sequence[str],
    frames_root: str,
    out_path: str,
    preprocess_fn: Callable[[np.ndarray], dict],
    encode_image_fn: Callable[[dict], np.ndarray],
    bsz: int = 64,
    max_frames: int = 0,
    feature_format: str = "hdf5",
) -> int:
    """Write video_id -> (T, Dt) per-frame CLIP embeddings to the store
    `out_path` names. Returns the number of videos written."""
    open_store = _store_writer(feature_format)
    out_path = store_path(out_path, feature_format)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    n = 0
    with open_store(out_path) as f:
        for vid, frames in iter_video_frames(video_ids, frames_root,
                                             max_frames):
            rows = []
            for chunk in _batched(frames, bsz):
                rows.append(np.asarray(
                    encode_image_fn(preprocess_fn(np.asarray(chunk))),
                    np.float32))
            f.create_dataset(vid, data=np.concatenate(rows))
            n += 1
    return n


def build_tokenize_fn() -> Callable[[List[str]], dict]:
    """Default tokenizer: the in-repo CLIP BPE (tools/clip_tokenizer.py and
    assets/bpe_simple_vocab_16e6.txt.gz)."""
    from dldkd_tpu_torch.tools.clip_tokenizer import ClipTokenizer

    tok = ClipTokenizer()
    return lambda texts: tok.tokenize(texts)


def build_clip_fns(model_dir: str, use_hf_tokenizer: bool = False,
                   device=None) -> Dict[str, Callable]:
    """Wire the CLIP of a LOCAL model directory on `device` (default
    "cuda"). Returns tokenize / encode_text / preprocess / encode_image
    callables; the encoders take host or device arrays and return numpy
    float32. Tokenization defaults to the in-repo BPE; use_hf_tokenizer
    loads transformers' tokenizer from model_dir instead."""
    from dldkd_tpu_torch import resolve_device
    from dldkd_tpu_torch.models.clip import load_clip
    from dldkd_tpu_torch.tools.clip_preprocess import build_preprocess_fn

    dev = resolve_device(device)
    model = load_clip(model_dir, dev)
    preprocess_fn = build_preprocess_fn(model_dir, dev)

    if use_hf_tokenizer:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(model_dir,
                                                  local_files_only=True)

        def tokenize_fn(texts):
            enc = tokenizer(texts, padding="max_length", truncation=True,
                            max_length=77, return_tensors="np")
            return {"input_ids": enc["input_ids"],
                    "attention_mask": enc["attention_mask"]}
    else:
        tokenize_fn = build_tokenize_fn()

    @torch.inference_mode()
    def encode_text_fn(inputs):
        return model.get_text_features(
            torch.as_tensor(inputs["input_ids"]).to(dev),
            torch.as_tensor(inputs["attention_mask"]).to(dev)).cpu().numpy()

    @torch.inference_mode()
    def encode_image_fn(inputs):
        return model.get_image_features(
            torch.as_tensor(inputs["pixel_values"]).to(dev)).cpu().numpy()

    return {"tokenize": tokenize_fn, "encode_text": encode_text_fn,
            "preprocess": preprocess_fn, "encode_image": encode_image_fn}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--mode", choices=["text", "video"], required=True)
    p.add_argument("--collection", required=True)
    p.add_argument("--root_path", required=True)
    p.add_argument("--split", default="train",
                   choices=["train", "val", "test"])
    p.add_argument("--clip_model", required=True,
                   help="local CLIP model dir (config.json, "
                        "flax_model.msgpack, preprocessor_config.json)")
    p.add_argument("--frames_root", default=None,
                   help="dir of <video_id>/ frame images or <video_id>.npy")
    p.add_argument("--bsz", type=int, default=256)
    p.add_argument("--max_frames", type=int, default=0)
    p.add_argument("--hf_tokenizer", action="store_true",
                   help="tokenize with the HF tokenizer from --clip_model "
                        "instead of the in-repo CLIP BPE")
    p.add_argument("--feature_format", choices=FEATURE_FORMATS,
                   default="hdf5",
                   help="hdf5 (needs h5py) or the .npz twin")
    p.add_argument("--torch_device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    if args.mode == "video" and not args.frames_root:
        p.error("--frames_root is required for --mode video")
    _store_writer(args.feature_format)   # fail before loading the model

    base = os.path.join(args.root_path, args.collection)
    cap_file = os.path.join(
        base, "TextData", f"{args.collection}{args.split}.caption.txt")
    fns = build_clip_fns(args.clip_model, use_hf_tokenizer=args.hf_tokenizer,
                         device=args.torch_device)

    if args.mode == "text":
        out = os.path.join(
            base, "TextData",
            f"clip_ViT_B_32_{args.collection}_query_feat.hdf5")
        n = extract_query_features(cap_file, out, fns["tokenize"],
                                   fns["encode_text"], args.bsz,
                                   args.feature_format)
        what = "caption"
    else:
        out = os.path.join(
            base, "FeatureData",
            f"new_clip_vit_32_{args.collection}_vid_features.hdf5")
        n = extract_video_features(read_video_ids(cap_file),
                                   args.frames_root, out, fns["preprocess"],
                                   fns["encode_image"], args.bsz,
                                   args.max_frames, args.feature_format)
        what = "video"
    print(f"wrote {n} {what} features -> "
          f"{store_path(out, args.feature_format)}")
    return n


if __name__ == "__main__":
    main()
