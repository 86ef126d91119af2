"""The one generator of the benchmark's inputs and weights, from `--seed`.

Everything is drawn on the run's device from a `torch.Generator` seeded
with the seed, in a few large calls, and the inputs are handed over as
host numpy arrays, as the program's data packers hand them (the pattern
of the program's serving inputs, kept here as the benchmark's own copy).

- Valid lengths (frames per video, tokens per query) are an even grid
  over the mix's [lo, hi], permuted by the seed: every seed gives the
  same set of lengths in another order, so seeds change no work.
- Video frames are uniform [0, 1) (non-negative, as I3D and ResNet
  features are); token features are normal, L2-normalized per token, as
  the packer stores them; teacher (CLIP) features are normal. Padded
  frames and tokens are zero and masked.
- Weights follow the reference's init (normal(0, initializer_range)
  weights and embeddings, zero biases, unit LayerNorms), every normal
  leaf from one draw.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import model as ref

CHUNK_BYTES = 256 << 20   # largest transient drawn on the device at once


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % 2**63)


def grid_lengths(n: int, lo: int, hi: int, gen: torch.Generator,
                 device) -> np.ndarray:
    """n lengths spread evenly over [lo, hi], in the seed's order."""
    grid = lo + (np.arange(n) * (hi - lo + 1)) // max(n, 1)
    perm = torch.randperm(n, generator=gen, device=device).cpu().numpy()
    return grid[perm].astype(np.int64)


def masks(lengths: np.ndarray, width: int) -> np.ndarray:
    return (np.arange(width)[None, :] < lengths[:, None]).astype(np.float32)


def _fill(out: np.ndarray, mask: np.ndarray, draw, gen, device) -> None:
    """out[s:e] = draw(shape) * mask, drawn on the device chunk by chunk
    and copied into the host array."""
    row = int(np.prod(out.shape[1:])) * 4
    step = max(1, CHUNK_BYTES // row)
    host = torch.from_numpy(out)
    for s in range(0, out.shape[0], step):
        e = min(s + step, out.shape[0])
        x = draw((e - s,) + out.shape[1:], gen, device)
        m = torch.from_numpy(mask[s:e]).to(device)
        x = x * m.reshape(m.shape + (1,) * (x.dim() - m.dim()))
        host[s:e].copy_(x)


def uniform(shape, gen, device):
    return torch.rand(shape, generator=gen, device=device)


def normal(shape, gen, device):
    return torch.randn(shape, generator=gen, device=device)


def unit_tokens(shape, gen, device):
    x = torch.randn(shape, generator=gen, device=device)
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def videos(n: int, cfg: dict, mix: dict, gen, device,
           teacher: bool = False) -> Dict[str, np.ndarray]:
    lens = grid_lengths(n, *mix["video_frames"], gen, device)
    vmask = masks(lens, cfg["max_ctx_l"])
    feats = np.empty((n, cfg["max_ctx_l"], cfg["visual_input_size"]),
                     np.float32)
    _fill(feats, vmask, uniform, gen, device)
    out = {"vfeats": feats, "vmask": vmask}
    if teacher:
        tv = np.empty((n, cfg["max_ctx_l"], cfg["teacher_size"]),
                      np.float32)
        _fill(tv, vmask, normal, gen, device)
        out["tvfeats"] = tv
    return out


def queries(n: int, cfg: dict, mix: dict, gen, device,
            teacher: bool = False) -> Dict[str, np.ndarray]:
    lens = grid_lengths(n, *mix["query_tokens"], gen, device)
    qmask = masks(lens, cfg["max_desc_l"])
    feats = np.empty((n, cfg["max_desc_l"], cfg["query_input_size"]),
                     np.float32)
    _fill(feats, qmask, unit_tokens, gen, device)
    out = {"qfeats": feats, "qmask": qmask}
    if teacher:
        tq = np.empty((n, cfg["teacher_size"]), np.float32)
        _fill(tq, np.ones((n,), np.float32), normal, gen, device)
        out["tqfeats"] = tq
    return out


def eval_inputs(cfg: dict, mix: dict, seed: int, device) -> dict:
    """The eval split: n_videos videos, n_queries queries, query i's
    ground truth a video drawn so that every video has
    floor or ceil(n_queries / n_videos) captions."""
    gen = generator(seed, device)
    nv, nq = cfg["n_videos"], cfg["n_queries"]
    out = videos(nv, cfg, mix, gen, device)
    out.update(queries(nq, cfg, mix, gen, device))
    perm = torch.randperm(nq, generator=gen, device=device).cpu().numpy()
    out["gt"] = (perm % nv).astype(np.int64)
    return out


def train_inputs(cfg: dict, mix: dict, seed: int, device) -> dict:
    """The training pool: n_train_videos videos with teacher frames,
    captions_per_video captions each (rows video-major), teacher
    sentence features; `caps` lists each video's caption rows."""
    gen = generator(seed, device)
    nv, per = cfg["n_train_videos"], cfg["captions_per_video"]
    out = videos(nv, cfg, mix, gen, device, teacher=True)
    out.update(queries(nv * per, cfg, mix, gen, device, teacher=True))
    out["caps"] = [np.arange(i * per, (i + 1) * per) for i in range(nv)]
    return out


def weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The model's parameters under the reference's names, on `device`."""
    spec = ref.param_spec(cfg)
    # a stream of its own, apart from the inputs' stream of the same seed
    gen = generator((int(seed) * 1000003 + 17) % 2**63, device)
    n_normal = sum(int(np.prod(s)) for _, s, init in spec if init == "normal")
    flat = torch.randn(n_normal, generator=gen, device=device) \
        * cfg["initializer_range"]
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape, init in spec:
        if init == "normal":
            k = int(np.prod(shape))
            out[name] = flat[at:at + k].view(shape).clone()
            at += k
        else:
            fill = 1.0 if init == "ones" else 0.0
            out[name] = torch.full(shape, fill, device=device)
    return out


def ids(prefix: str, n: int) -> List[str]:
    return [f"{prefix}{i}" for i in range(n)]
