"""CLIP frame preprocessing on the device: transformers' CLIPImageProcessor
(the slow, PIL-backed one the JAX extraction tool gets) on uint8 frames.

Steps, per `preprocessor_config.json`:
1. resize the shortest edge to `size.shortest_edge` (the long edge becomes
   int(size * long / short)) with PIL's bicubic filter;
2. center-crop to `crop_size` (top = (h - crop_h) // 2, likewise left);
3. x * rescale_factor in float64, then float32;
4. (x - image_mean) / image_std in float32.

The resize is PIL's own arithmetic, reproduced bit for bit
(`pil_bicubic_weights`): two separable passes, horizontal first, each
output a sum of input bytes times fixed-point weights (22 fraction bits,
PIL's `precompute_coeffs` for bicubic a = -0.5 with support 2 max(in/out,
1), normalized, rounded half away from zero), then
clamp(floor((sum + 2**21) / 2**22), 0, 255). Here each pass is one
float64 product with a weight matrix: every product and partial sum is an
integer below 2**53, so any summation order, on any device, gives PIL's
bytes. Only the rows and columns the crop keeps are computed (each output
pixel depends on its own weight row alone). `F.interpolate`'s antialiased
bicubic is not PIL's: it differs on a fifth of the pixels, by up to 20
levels on noise.
"""

from __future__ import annotations

import functools
import json
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

PREPROCESSOR_NAME = "preprocessor_config.json"
OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
PIL_BICUBIC = 3
_PRECISION_BITS = 22          # PIL: 32 - 8 - 2 for 8-bit images


@dataclass(frozen=True)
class PreprocessConfig:
    shortest_edge: int = 224
    crop_size: Tuple[int, int] = (224, 224)         # (height, width)
    rescale_factor: float = 1 / 255
    image_mean: Tuple[float, ...] = OPENAI_CLIP_MEAN
    image_std: Tuple[float, ...] = OPENAI_CLIP_STD
    do_resize: bool = True
    do_center_crop: bool = True
    do_rescale: bool = True
    do_normalize: bool = True

    @classmethod
    def from_dict(cls, d: dict) -> "PreprocessConfig":
        """preprocessor_config.json's content; `size` / `crop_size` as an
        int (older files) or a dict."""
        if d.get("resample", PIL_BICUBIC) != PIL_BICUBIC:
            raise ValueError(f"resample {d['resample']}: only PIL bicubic "
                             f"({PIL_BICUBIC}) is implemented")
        size = d.get("size", 224)
        if isinstance(size, dict):
            if "shortest_edge" not in size:
                raise ValueError(f"size {size}: only shortest_edge is "
                                 f"implemented")
            size = size["shortest_edge"]
        crop = d.get("crop_size", 224)
        crop = ((crop["height"], crop["width"]) if isinstance(crop, dict)
                else (crop, crop))
        base = cls()
        return cls(
            shortest_edge=int(size), crop_size=(int(crop[0]), int(crop[1])),
            rescale_factor=float(d.get("rescale_factor",
                                       base.rescale_factor)),
            image_mean=tuple(d.get("image_mean", base.image_mean)),
            image_std=tuple(d.get("image_std", base.image_std)),
            **{k: bool(d.get(k, True)) for k in (
                "do_resize", "do_center_crop", "do_rescale",
                "do_normalize")})

    def to_dict(self) -> dict:
        return {"image_processor_type": "CLIPImageProcessor",
                "size": {"shortest_edge": self.shortest_edge},
                "crop_size": {"height": self.crop_size[0],
                              "width": self.crop_size[1]},
                "resample": PIL_BICUBIC,
                "rescale_factor": self.rescale_factor,
                "image_mean": list(self.image_mean),
                "image_std": list(self.image_std),
                "do_resize": self.do_resize,
                "do_center_crop": self.do_center_crop,
                "do_rescale": self.do_rescale,
                "do_normalize": self.do_normalize,
                "do_convert_rgb": True}


def read_preprocess_config(model_dir: str) -> PreprocessConfig:
    with open(os.path.join(model_dir, PREPROCESSOR_NAME)) as f:
        return PreprocessConfig.from_dict(json.load(f))


def resize_shape(h: int, w: int, shortest_edge: int) -> Tuple[int, int]:
    """(height, width) after the shortest-edge resize (transformers'
    get_resize_output_image_size, default_to_square=False)."""
    short, long = (w, h) if w <= h else (h, w)
    new_long = int(shortest_edge * long / short)
    return (new_long, shortest_edge) if w <= h else (shortest_edge, new_long)


def _bicubic(x: float) -> float:
    """PIL's bicubic_filter, a = -0.5, in its operation order."""
    a = -0.5
    if x < 0.0:
        x = -x
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


@functools.lru_cache(maxsize=64)
def pil_bicubic_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) int64: PIL's fixed-point bicubic weights
    (Resample.c precompute_coeffs + normalize_coeffs_8bpc) for resizing
    in_size samples to out_size."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    weights = np.zeros((out_size, in_size), np.int64)
    one = 1 << _PRECISION_BITS
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_bicubic((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        for x, w in enumerate(k):
            if ww != 0.0:
                w /= ww
            # (int)(w * 2**22 +- 0.5): half away from zero, then truncate
            weights[xx, xmin + x] = int(-0.5 + w * one if w < 0
                                        else 0.5 + w * one)
    weights.setflags(write=False)   # shared by every caller of the cache
    return weights


def _fixed_point_pass(x: torch.Tensor) -> torch.Tensor:
    """PIL's rounding of a pass's fixed-point sums, as float64 bytes."""
    half = float(1 << (_PRECISION_BITS - 1))
    return torch.floor((x + half) / float(1 << _PRECISION_BITS)
                       ).clamp_(0.0, 255.0)


def _weight_rows(n_in: int, n_out: int, first: int, n: int, device
                 ) -> Optional[torch.Tensor]:
    """Rows [first, first + n) of the float64 weights resizing n_in
    samples to n_out, on the device; None when the size stays (PIL skips
    that pass)."""
    if n_in == n_out:
        return None
    m = pil_bicubic_weights(n_in, n_out)[first:first + n]
    return torch.from_numpy(m.astype(np.float64)).to(device)


def _resample(x: torch.Tensor, rows, cols, box) -> torch.Tensor:
    """float64 bytes (B, C, H, W) -> the (top, left, h, w) box of their
    resize, through the restricted weights `rows` and `cols`."""
    top, left, h, w = box
    if cols is None:
        x = x[..., left:left + w]
    else:   # horizontal pass first, as PIL
        x = _fixed_point_pass(torch.matmul(x, cols.T))
    if rows is None:
        return x[..., top:top + h, :]
    return _fixed_point_pass(torch.matmul(rows, x))


def _as_nchw(frames, device) -> torch.Tensor:
    """uint8 (B, H, W, 3), numpy or tensor -> float64 (B, 3, H, W) on the
    device; numpy goes through pinned memory to a card."""
    if not torch.is_tensor(frames):
        frames = torch.from_numpy(np.ascontiguousarray(frames, np.uint8))
        if device.type == "cuda":
            frames = frames.pin_memory()
    if frames.dim() != 4 or frames.shape[-1] != 3:
        raise ValueError(f"frames must be (B, H, W, 3), got "
                         f"{tuple(frames.shape)}")
    return (frames.to(device, non_blocking=True).permute(0, 3, 1, 2)
            .to(torch.float64))


class ClipPreprocessor:
    """uint8 frames (B, H, W, 3) -> `pixel_values` (B, 3, crop_h, crop_w)
    float32 on `device`. The weight matrices are built once per frame
    size and kept on the device."""

    def __init__(self, cfg: PreprocessConfig, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self._plans = {}
        self.mean = torch.tensor(cfg.image_mean, dtype=torch.float32,
                                 device=self.device).view(1, -1, 1, 1)
        self.std = torch.tensor(cfg.image_std, dtype=torch.float32,
                                device=self.device).view(1, -1, 1, 1)

    def _plan(self, h: int, w: int):
        """(rows, cols, crop box) for frames of h x w."""
        if (h, w) not in self._plans:
            cfg = self.cfg
            rh, rw = (resize_shape(h, w, cfg.shortest_edge)
                      if cfg.do_resize else (h, w))
            ch, cw = cfg.crop_size if cfg.do_center_crop else (rh, rw)
            if ch > rh or cw > rw:
                raise ValueError(f"crop {(ch, cw)} exceeds the resized "
                                 f"frame {(rh, rw)}")
            top, left = (rh - ch) // 2, (rw - cw) // 2
            self._plans[(h, w)] = (
                _weight_rows(h, rh, top, ch, self.device),
                _weight_rows(w, rw, left, cw, self.device),
                (top, left, ch, cw))
        return self._plans[(h, w)]

    def resize_crop(self, frames) -> torch.Tensor:
        """uint8 (B, H, W, 3) -> the resized and center-cropped frames as
        float64 bytes, (B, 3, crop_h, crop_w)."""
        x = _as_nchw(frames, self.device)
        return _resample(x, *self._plan(x.shape[2], x.shape[3]))

    def __call__(self, frames) -> torch.Tensor:
        x = self.resize_crop(frames)
        if self.cfg.do_rescale:
            x = x * self.cfg.rescale_factor
        x = x.to(torch.float32)
        if self.cfg.do_normalize:
            x = (x - self.mean) / self.std
        return x


def build_preprocess_fn(model_dir: str, device=None):
    """frames (T, H, W, 3) uint8 -> {"pixel_values": (T, 3, h, w) float32
    on the device}, from `model_dir`'s preprocessor_config.json."""
    from dldkd_tpu_torch import resolve_device

    pre = ClipPreprocessor(read_preprocess_config(model_dir),
                           resolve_device(device))
    return lambda frames: {"pixel_values": pre(frames)}
