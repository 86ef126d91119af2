"""The serving benchmarks' workload: TVR test-split shapes and the serving
model configuration (the port's copy of bench.py:42-67).

Every port bench (`tools/{stage,search,stream,coldstart}_bench.py` and
`tools/bench.py`) reads its shapes from here, as the JAX package's tools
read theirs from the root `bench.py`; the port imports nothing of that
file, so the constants are kept here, in step with it (a CPU test holds
them equal). The helpers below are what those tools share: the seeded
model, the device-resident inputs, the per-rep salted weights, the timing
protocol and the device's name.
"""

from __future__ import annotations

import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

from dldkd_tpu_torch.config import ModelConfig
from dldkd_tpu_torch.ops.fast_eval import tower_weights

# TVR test-split scale: ~2.2k corpus videos, ~11k queries
N_VIDEOS = 2179
N_QUERIES = 10895
L_FRAMES = 128
D_STUDENT = 1024
D_QUERY = 768
L_TOKENS = 30
L_TOK_PAD = 32    # serving packs tokens on the kernels' 8-token grid
QUERY_BSZ = 1024  # rounds 10,895 queries to 11,264
VIDEO_GRID = 128  # bench.py pads the corpus to a multiple of 128 videos
# the checkout's root: the benches' subprocesses run from it
REPO_ROOT = str(Path(__file__).resolve().parents[2])


def serving_model_config() -> ModelConfig:
    """The serving benchmarks' model: both branches at hidden 384, 4
    heads, soft labels, bf16 towers, matmul precision "default"."""
    return ModelConfig(
        visual_input_size=D_STUDENT, query_input_size=D_QUERY,
        inheritance_hidden=384, exploration_hidden=384,
        max_ctx_l=L_FRAMES, max_desc_l=L_TOKENS, n_heads=4,
        double_branch=True, label_style="soft",
        dtype="bfloat16", matmul_precision="default",
    )


def pad_to(n: int, grid: int) -> int:
    """n rounded up to a multiple of grid."""
    return -(-n // grid) * grid


def serving_model(seed: int = 0, device=None, one_branch_of=None):
    """The serving model with seeded random weights (`init_weights` from a
    torch.Generator seeded with `seed`), in eval mode on `device`. With
    `one_branch_of` (a two-branch model) it is instead a single-branch
    model holding that model's inheritance weights, so that its towers run
    one branch per launch."""
    from dldkd_tpu_torch.models import DLDKD

    cfg = serving_model_config()
    if one_branch_of is None:
        model = DLDKD(cfg).init_weights(torch.Generator().manual_seed(seed))
    else:
        model = DLDKD(cfg.replace(double_branch=False))
        mine = model.state_dict()
        model.load_state_dict({k: v for k, v in
                               one_branch_of.state_dict().items()
                               if k in mine}, strict=True)
    return model.to(device).eval() if device is not None else model.eval()


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sync(dev: torch.device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def card() -> Optional[str]:
    """The card's name and power limit as nvidia-smi prints them
    (`--query-gpu=name,power.limit --format=csv,noheader`), or None
    without nvidia-smi."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


class Timing(NamedTuple):
    first_s: float       # the first call, first use included
    per_call_s: float    # the best window's seconds per call
    first: object        # the first call's result
    last: object         # the last call's result


def timed(fn: Callable[[int], object], reps: int, dev: torch.device,
          blocks: int = 1) -> Timing:
    """The benches' timing protocol: one first call fn(0), then `blocks`
    windows of `reps` calls fn(1), ..., fn(reps), each window ended by one
    device synchronize (a salted call k adds 1e-4 * k, as the JAX tools
    salt rep k - 1)."""
    t0 = time.perf_counter()
    first = last = fn(0)
    sync(dev)
    first_s = time.perf_counter() - t0
    best = math.inf
    for _ in range(blocks):
        t0 = time.perf_counter()
        for k in range(1, reps + 1):
            last = fn(k)
        sync(dev)
        best = min(best, (time.perf_counter() - t0) / reps)
    return Timing(first_s, best, first, last)


def serving_inputs(dev: torch.device, n_videos: int, n_queries: int,
                   video_grid: Optional[int] = None,
                   query_grid: Optional[int] = None,
                   seed: int = 0) -> Dict[str, torch.Tensor]:
    """bench.py's serving inputs, drawn on `dev` from a torch.Generator
    seeded with `seed` (bench.py:114-130): the corpus padded to a multiple
    of `video_grid` videos (default VIDEO_GRID), uniform [0, 1) frames
    stored in bf16, padded videos masked out; queries padded to a multiple
    of `query_grid` (default QUERY_BSZ), uniform f32 on L_TOK_PAD tokens of
    which the first L_TOKENS are valid; query i's ground truth is video i
    mod n_videos."""
    video_grid = video_grid or VIDEO_GRID
    query_grid = query_grid or QUERY_BSZ
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_vid_pad = pad_to(n_videos, video_grid)
    n_q_pad = pad_to(n_queries, query_grid)
    vfeats = torch.empty((n_vid_pad, L_FRAMES, D_STUDENT),
                         dtype=torch.bfloat16, device=dev)
    # 128 videos at a time through f32: no corpus-sized f32 transient
    for s in range(0, n_vid_pad, 128):
        n = min(128, n_vid_pad - s)
        vfeats[s:s + n] = torch.rand((n, L_FRAMES, D_STUDENT), generator=gen,
                                     device=dev)
    vmask = (torch.arange(n_vid_pad, device=dev) < n_videos).float()
    qmask = (torch.arange(L_TOK_PAD, device=dev) < L_TOKENS).float()
    return {"vfeats": vfeats,
            "vmask": vmask[:, None].expand(n_vid_pad, L_FRAMES).contiguous(),
            "qfeats": torch.rand((n_q_pad, L_TOK_PAD, D_QUERY),
                                 generator=gen, device=dev),
            "qmask": qmask[None].expand(n_q_pad, L_TOK_PAD).contiguous(),
            "gt": (torch.arange(n_q_pad, device=dev) % n_videos).to(
                torch.int32)}


class SaltedWeights:
    """The model's tower weights with every parameter salted: `(salt)`
    sets each parameter to its original value + salt and packs the towers'
    operands anew (`fast_eval.tower_weights`), as bench.py's programs add
    the salt to every parameter (bench.py:160, :199) so that no rep can
    reuse another's results. Salt 0 restores the original weights."""

    def __init__(self, model, dev: torch.device):
        self.model, self.dev = model, dev
        self.params: List[torch.Tensor] = list(model.parameters())
        self.base = [p.detach().clone() for p in self.params]

    @torch.no_grad()
    def __call__(self, salt: float) -> Dict[str, list]:
        for p, p0 in zip(self.params, self.base):
            p.copy_(p0 + salt)
        return tower_weights(self.model, self.dev)
