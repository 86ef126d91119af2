"""The work a cell's algorithm needs, counted from the configuration's
shapes: floating-point operations (a multiply-add is two) and bytes.

What is counted is the algorithm, not an implementation: each product
once (a 3xTF32 product that runs three passes counts once), every frame
and token position of the padded length (the towers and the scorer
compute them all and mask afterwards), each input byte read once and
each output byte written once. Elementwise work (LayerNorm, softmax,
masking, the max over frames, ranks) is left out of the operations; it
is a small share and bound by bytes that are already counted.

Peaks of one NVIDIA H100 SXM (the data sheet's dense rates, 700 W):
495 TFLOP/s for TF32, the fastest rate at which the card multiplies f32
inputs, and 3.35 TB/s of HBM.
"""

from __future__ import annotations

import math
from typing import Dict

from benchmark.reference import model as ref

PEAK_FLOPS = 495e12
PEAK_BYTES = 3.35e12
F32 = 4


def attention_block_flops(l: int, h: int) -> int:
    """One BERT self-attention block on one sequence of l positions:
    Q, K, V and the output projection (4 products of h x h per position)
    and the two attention products (scores and probs @ V)."""
    return 2 * l * 4 * h * h + 2 * 2 * l * l * h


def video_tower_flops(l: int, d_in: int, h: int) -> int:
    """One video through one branch's video tower: the input projection,
    the attention block, the output mapping."""
    return 2 * l * d_in * h + attention_block_flops(l, h) + 2 * l * h * h


def query_tower_flops(l: int, d_in: int, h: int) -> int:
    """One query through one branch's query tower: the input projection,
    the attention block, the pooling's 1-d head and weighted sum."""
    return 2 * l * d_in * h + attention_block_flops(l, h) + 2 * 2 * l * h


def score_flops(n_q: int, n_v: int, l: int, h: int) -> int:
    """Cosines of n_q pooled queries against every frame of n_v videos."""
    return 2 * n_q * n_v * l * h


def n_params(cfg: dict) -> int:
    return sum(math.prod(shape) for _, shape, _ in ref.param_spec(cfg))


def n_branches(cfg: dict) -> int:
    return 2 if cfg["double_branch"] else 1


def eval_work(cfg: dict) -> Dict[str, float]:
    """One retrieval eval of the configuration's corpus and queries: both
    towers over every video and query of every branch, the masked-cosine
    scores of every pair, ranks of the ground truth."""
    nv, nq = cfg["n_videos"], cfg["n_queries"]
    l, lq, h = cfg["max_ctx_l"], cfg["max_desc_l"], cfg["inheritance_hidden"]
    nb = n_branches(cfg)
    flops = nb * (nv * video_tower_flops(l, cfg["visual_input_size"], h)
                  + nq * query_tower_flops(lq, cfg["query_input_size"], h)
                  + score_flops(nq, nv, l, h))
    n_ranks = nb + (1 if nb == 2 else 0)
    bytes_ = F32 * (nv * l * (cfg["visual_input_size"] + 1)
                    + nq * lq * (cfg["query_input_size"] + 1)
                    + n_params(cfg) + nq * n_ranks)
    return {"flops": float(flops), "bytes": float(bytes_)}


def search_work(cfg: dict, n_queries: int, k: int) -> Dict[str, float]:
    """One `Retriever.search` call that carried n_queries real queries at
    top k, counted from the harness's own numbers, not from what the
    program does inside the call (padding to its batch size, the number
    of launches). Operations: both branches' query towers over the real
    queries, and their cosines against every frame of every video.
    Bytes: the encoded index read once (every video's frames of both
    branches, f32, and their mask), the real queries' tokens and masks
    read once, the k ids and scores of each query written once."""
    nv, l, lq = cfg["n_videos"], cfg["max_ctx_l"], cfg["max_desc_l"]
    h = cfg["inheritance_hidden"]
    nb = n_branches(cfg)
    flops = nb * (n_queries * query_tower_flops(lq, cfg["query_input_size"],
                                                h)
                  + score_flops(n_queries, nv, l, h))
    bytes_ = (F32 * (nb * nv * l * h + nv * l
                     + n_queries * lq * (cfg["query_input_size"] + 1))
              + n_queries * k * (F32 + 8))
    return {"flops": float(flops), "bytes": float(bytes_)}


def train_step_flops(cfg: dict) -> float:
    """One training step: three times the student's forward (the
    backward is two forwards' products) over the batch's videos and its
    padded caption axis, both towers and the frame scores that the
    losses read (cosine and raw dot products, each (Nq, L, B)); plus the
    teacher's frame scores once (no gradient)."""
    b, l, lq = cfg["bsz"], cfg["max_ctx_l"], cfg["max_desc_l"]
    h = cfg["inheritance_hidden"]
    nq = -(-b * cfg["captions_per_video"] // cfg["query_pad_multiple"]) \
        * cfg["query_pad_multiple"]
    nb = n_branches(cfg)
    student = nb * (b * video_tower_flops(l, cfg["visual_input_size"], h)
                    + nq * query_tower_flops(lq, cfg["query_input_size"], h)
                    + 2 * score_flops(nq, b, l, h))
    teacher = 2 * score_flops(nq, b, l, cfg["teacher_size"])
    return float(3 * student + teacher)


def least_seconds(flops: float, bytes_: float) -> float:
    """The least time the card could take: the larger of the two
    bounds."""
    return max(flops / PEAK_FLOPS, bytes_ / PEAK_BYTES)
