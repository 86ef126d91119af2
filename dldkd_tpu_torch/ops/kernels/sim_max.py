"""Fused scoring with a max over frames: masked cosine (kernel 1), int8
(kernel 4) and exact-grade rescoring against bf16 frames (kernel 5).

Replaces, in dldkd_tpu/ops/pallas/sim_max.py:
- `_sim_max_kernel`, through `fused_clip_scores(quantized=False)`:
  `fused_clip_scores` here;
- `_sim_max_kernel_int8`, through `fused_clip_scores_q8` and
  `fused_clip_scores(quantized=True)`: `fused_clip_scores_int8` and
  `fused_clip_scores_q8` here;
- `_sim_max_kernel_exact`, through `fused_exact_scores`: `fused_exact_scores`
  here.
All four instances are one tensor-core kernel, `csrc/sim_max_mma.cu`
(entries `sim_max_bf16`, `sim_max_f32`, `sim_max_int8`, `sim_max_exact`),
whose header says what bounds it on an H100 and how the design answers
that. Normalization, quantization of the query side and the frame scales
stay outside the kernel, in plain torch, as the JAX package keeps them
outside pallas_call.

Split products. f32 scoring multiplies on the tensor cores in 3xTF32:
each operand is split into a TF32 part and an exact f32 remainder
(`split_tf32`) and three products are summed, as the JAX package's f32
scoring runs at "highest" precision (XLA's multi-pass bf16 emulation of f32
on the MXU), not in IEEE f32 products. Exact rescoring splits the f32 query
into three bf16 parts (`split_bf16x3`), the Pallas kernel's own rounding,
so that its three bf16 products are exact. The kernel makes both splits
itself; the helpers here are the same arithmetic for the tests.

The int8 index keeps the port's own layout: (Nv, L, D) int8 rows and an
(Nv, L) int32 bias, 0 on valid frames and INT8_MASK_BIAS on masked or padded
ones (no transpose, no padding to a lane grid). The TPU's grid (videos
padded to `V_LANES`, frames to `pick_q8_l_tile`, frames first) is kept here
for the towers' transposed int8 emission (`query_tower.context_towers(...,
q8_transposed=True)`) and its bias (`q8_index_bias(mask, l_p, nv_p)`).

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU tensor
it runs its plain PyTorch version (full f32 products), which the CPU tests
hold against the Pallas kernels in interpret mode. Under a torch profiler
each wrapper's call is one span on either path (kernels/sim_max,
kernels/sim_max_int8, kernels/sim_max_exact; `utils/tracing.py`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dldkd_tpu_torch.ops.kernels.query_tower import (INT8_SCALE,
                                                     quantize_unit_int8)
from dldkd_tpu_torch.ops.masking import NEG_INF, l2_normalize, mask_logits
from dldkd_tpu_torch.utils.tracing import traced

# launches of the CUDA kernels since the counts were last set to 0; the
# masked-cosine scorer also by its dtype (sim_max_bf16, sim_max_f32)
LAUNCHES = {"sim_max": 0, "sim_max_bf16": 0, "sim_max_f32": 0,
            "sim_max_int8": 0, "sim_max_exact": 0}

INT8_MASK_BIAS = -(1 << 30)   # int32 "-inf": dominates any |s| <= D * 127^2
V_LANES = 128   # the TPU index's video grid (dldkd_tpu/ops/pallas/sim_max.py)
# the TPU scoring kernels' VMEM budget, half of it for the corpus block
# (dldkd_tpu/ops/similarity.py:_pick_tiles)
_TPU_TILE_BUDGET = 8 * 1024 * 1024
NEG_BIG_INT8 = INT8_MASK_BIAS / (INT8_SCALE * INT8_SCALE)   # dequantized
# float32(1 / 127^2), the constant the TPU kernel multiplies by
# (sim_max.py:216-217), held as the Python float of that f32 value
INV_SCALE2 = float(np.float32(1.0 / (INT8_SCALE * INT8_SCALE)))

# the exact kernel's deepest rows: its three resident bf16 query parts
# (3 x 64 rows x D x 2 bytes), its ring and frame scales fit in 227 KB of
# shared memory up to 7 depth chunks of 64 values
EXACT_MAX_DEPTH = 448

# bytes of f32 frame scores the plain versions hold at once
_PLAIN_CHUNK_BYTES = 256 * 1024 * 1024

def _query_chunk(nv: int, l_frames: int) -> int:
    return max(1, _PLAIN_CHUNK_BYTES // max(1, nv * l_frames * 4))


def _same_device(what: str, *ts) -> torch.device:
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"{what}: inputs on several devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev


def _contiguous(what: str, **ts) -> None:
    for name, t in ts.items():
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def pad_depth(multiple: int, *ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The tensors with their last axis zero-padded to a multiple of
    `multiple`; the same tensors, uncopied, when it already is one. Zeros
    add nothing to a dot product, so the scores do not change."""
    d = ts[0].shape[-1]
    if d % multiple == 0:
        return ts
    return tuple(F.pad(t, (0, multiple - d % multiple)) for t in ts)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small) of f32 x as the f32 scoring kernel splits each operand:
    big is x rounded to TF32 (10 mantissa bits, to nearest with ties away
    from zero, as cvt.rna.tf32.f32 rounds), its low 13 bits zero; small =
    x - big, exact in f32, so big + small == x."""
    bits = x.float().contiguous().view(torch.int32)
    big = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return big, x.float() - big


def split_bf16x3(q: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three bf16 parts of f32 q that the exact kernel multiplies,
    dldkd_tpu/ops/pallas/sim_max.py:85-88's rounding (to nearest even):
    q1 + q2 + q3 == q exactly for normal f32 values."""
    q = q.float()
    q1 = q.to(torch.bfloat16)
    r = q - q1.float()
    q2 = r.to(torch.bfloat16)
    return q1, q2, (r - q2.float()).to(torch.bfloat16)


def _aligned16(what: str, **ts) -> None:
    """The tensor-core kernel reads rows in 16-byte copies."""
    for name, t in ts.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")


def _frame_shapes(what: str, q, c, *per_frame):
    if q.dim() != 2 or c.dim() != 3:
        raise ValueError(f"{what}: want q (Nq, D) and frames (Nv, L, D); "
                         f"got {tuple(q.shape)} and {tuple(c.shape)}")
    nv, l_frames, d = c.shape
    if q.shape[1] != d or any(tuple(t.shape) != (nv, l_frames)
                              for t in per_frame):
        raise ValueError(f"{what}: shape mismatch: q {tuple(q.shape)}, "
                         f"frames {tuple(c.shape)}, per-frame "
                         f"{[tuple(t.shape) for t in per_frame]}")


# ------------------------------------------------ kernel 1: masked cosine

def sim_max_plain(qn: torch.Tensor, cn: torch.Tensor, mask: torch.Tensor
                  ) -> torch.Tensor:
    """max_l mask_logits(<qn[q], cn[v, l]>, mask[v, l]) in f32, in query
    chunks so the (Nq, Nv, L) tensor is never built whole (at TVR scale it
    would be 12 GB). bf16 inputs widen exactly to f32, so the products are
    exact and the sums f32 like the kernel's. On a GPU this assumes f32
    matmuls in full f32 (torch.backends.cuda.matmul.allow_tf32 False, the
    default)."""
    nq, d = qn.shape
    nv, l_frames, _ = cn.shape
    c2 = cn.reshape(nv * l_frames, d).float()
    m = mask.float()
    chunk = _query_chunk(nv, l_frames)
    out = torch.empty((nq, nv), dtype=torch.float32, device=qn.device)
    for s in range(0, nq, chunk):
        frame = (qn[s:s + chunk].float() @ c2.T).reshape(-1, nv, l_frames)
        out[s:s + chunk] = mask_logits(frame, m[None]).amax(dim=-1)
    return out


def _check(qn, cn, mask):
    _frame_shapes("fused_clip_scores", qn, cn, mask)
    if qn.dtype != cn.dtype or qn.dtype not in (torch.float32,
                                                torch.bfloat16):
        raise ValueError(f"qn and cn need one dtype, f32 or bf16; got "
                         f"{qn.dtype} and {cn.dtype}")
    if mask.dtype != torch.float32:
        raise ValueError(f"mask must be f32, got {mask.dtype}")
    _same_device("fused_clip_scores", qn, cn, mask)
    _contiguous("fused_clip_scores", qn=qn, cn=cn, mask=mask)


@traced("kernels/sim_max")
def fused_clip_scores(qn: torch.Tensor, cn: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """(Nq, Nv) f32 scores from normalized queries qn (Nq, D) and frames
    cn (Nv, L, D) of one dtype (f32 or bf16) and an f32 mask (Nv, L)."""
    _check(qn, cn, mask)
    if qn.device.type == "cpu":
        return sim_max_plain(qn, cn, mask)
    from dldkd_tpu_torch.ops.kernels.build import bind, check

    # rows of 16-byte multiples: 4 f32 (3xTF32) or 8 bf16 values
    if qn.dtype == torch.float32:
        qn, cn = pad_depth(4, qn, cn)
        sym, fn = "sim_max_f32", bind("sim_max_mma", "sim_max_f32", 4, 4)
    else:
        qn, cn = pad_depth(8, qn, cn)
        sym, fn = "sim_max_bf16", bind("sim_max_mma", "sim_max_bf16", 4, 4)
    _aligned16("fused_clip_scores", qn=qn, cn=cn)
    nq, d = qn.shape
    nv, l_frames, _ = cn.shape
    out = torch.empty((nq, nv), dtype=torch.float32, device=qn.device)
    with torch.cuda.device(qn.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(qn.data_ptr(), cn.data_ptr(), mask.data_ptr(),
                out.data_ptr(), nq, nv, l_frames, d, stream)
    check(rc, sym)
    LAUNCHES["sim_max"] += 1
    LAUNCHES[sym] += 1
    return out


# ------------------------------------------------------- kernel 4: int8

def pick_q8_l_tile(d: int) -> int:
    """The TPU int8 index's frame tile for depth d: the itemsize-1 frame
    row of the JAX tile policy (dldkd_tpu/ops/similarity.py:_pick_tiles,
    through dldkd_tpu/ops/pallas/sim_max.py:pick_q8_l_tile): 16 frames,
    halved while a 16-frame x V_LANES-video x d int8 block passes half the
    VMEM budget."""
    l_tile = 16
    while l_tile * V_LANES * d > _TPU_TILE_BUDGET // 2 and l_tile > 1:
        l_tile //= 2
    return l_tile


def q8_index_bias(mask: torch.Tensor, l_p: Optional[int] = None,
                  nv_p: Optional[int] = None) -> torch.Tensor:
    """int32 mask bias of the int8 index: 0 on valid frames,
    INT8_MASK_BIAS on masked or padded ones. Without a grid: (Nv, L), the
    port's layout. With l_p and nv_p: (l_p, nv_p), the TPU layout of the
    towers' transposed emission, the mask padded with zeros to (nv_p, l_p)
    first (dldkd_tpu/ops/pallas/sim_max.py:q8_index_bias)."""
    if l_p is not None or nv_p is not None:
        nv, l_frames = mask.shape
        mask = F.pad(mask, (0, l_p - l_frames, 0, nv_p - nv)).T
    return torch.where(mask > 0, 0, INT8_MASK_BIAS).to(torch.int32)


def build_q8_index(ctx_q8: torch.Tensor, mask: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The prebuilt int8 scoring index from already-quantized frames
    (`query_tower.quantize_frames_q8` semantics): (rows (Nv, L, D) int8,
    contiguous; bias (Nv, L) int32). Built once per index; every later scoring call
    skips the corpus-sized normalize and quantize pass. (The JAX package's
    `build_q8_index` also transposes and pads to its TPU grid; this layout
    is the port's own.)"""
    if ctx_q8.dtype != torch.int8:
        raise ValueError(f"build_q8_index: want int8 rows, got {ctx_q8.dtype}")
    return ctx_q8.contiguous(), q8_index_bias(mask).contiguous()


def sim_max_int8_plain(q8: torch.Tensor, c8: torch.Tensor,
                       bias: torch.Tensor) -> torch.Tensor:
    """max_l (<q8[q], c8[v, l]> + bias[v, l]) * float32(1/127^2), in f32,
    in query chunks. The int8 products and their sums are integers below
    2^24 for D <= 1040, so f32 arithmetic is exact on valid frames and the
    valid-video scores are bitwise the integer kernel's (the same argument
    as dldkd_tpu's `_quantized_scores_xla`). On a GPU this assumes f32
    matmuls without TF32."""
    nq, d = q8.shape
    nv, l_frames, _ = c8.shape
    c2 = c8.reshape(nv * l_frames, d).float()
    b = bias.float()
    chunk = _query_chunk(nv, l_frames)
    out = torch.empty((nq, nv), dtype=torch.float32, device=q8.device)
    for s in range(0, nq, chunk):
        frame = (q8[s:s + chunk].float() @ c2.T).reshape(-1, nv, l_frames)
        out[s:s + chunk] = (frame + b[None]).amax(dim=-1) * INV_SCALE2
    return out


@traced("kernels/sim_max_int8")
def fused_clip_scores_int8(q8: torch.Tensor, c8: torch.Tensor,
                           bias: torch.Tensor, plain: bool = False
                           ) -> torch.Tensor:
    """(Nq, Nv) f32 int8 scores from quantized queries q8 (Nq, D) int8,
    an int8 index c8 (Nv, L, D) and its int32 bias (Nv, L). plain=True
    runs the plain version on any device."""
    what = "fused_clip_scores_int8"
    _frame_shapes(what, q8, c8, bias)
    if q8.dtype != torch.int8 or c8.dtype != torch.int8 \
            or bias.dtype != torch.int32:
        raise ValueError(f"{what}: want int8, int8, int32; got {q8.dtype}, "
                         f"{c8.dtype}, {bias.dtype}")
    dev = _same_device(what, q8, c8, bias)
    _contiguous(what, q8=q8, c8=c8, bias=bias)
    if plain or dev.type == "cpu":
        return sim_max_int8_plain(q8, c8, bias)
    from dldkd_tpu_torch.ops.kernels.build import bind, check

    q8, c8 = pad_depth(16, q8, c8)   # rows of 16-byte multiples
    _aligned16(what, q8=q8, c8=c8)
    nq, d = q8.shape
    nv, l_frames, _ = c8.shape
    out = torch.empty((nq, nv), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = bind("sim_max_mma", "sim_max_int8", 4, 4)(
            q8.data_ptr(), c8.data_ptr(), bias.data_ptr(), out.data_ptr(),
            nq, nv, l_frames, d, stream)
    check(rc, "sim_max_int8")
    LAUNCHES["sim_max_int8"] += 1
    return out


def fused_clip_scores_q8(query: torch.Tensor, c8: torch.Tensor,
                         bias: torch.Tensor, plain: bool = False
                         ) -> torch.Tensor:
    """int8 cosine scores (Nq, Nv) of float queries against a prebuilt
    index (`build_q8_index`): only the query side is normalized (in its own
    dtype) and quantized per call."""
    q8 = quantize_unit_int8(l2_normalize(query)).contiguous()
    return fused_clip_scores_int8(q8, c8, bias, plain)


# ------------------------------------------------ kernel 5: exact rescore

def exact_frame_scales(ctx: torch.Tensor, mask: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(inv, bias), each (Nv, L) f32: the reciprocal f32 norm of each
    stored frame (0 on masked frames) and 0 / -1e10, as
    dldkd_tpu/ops/pallas/sim_max.py:150-155 computes them."""
    norms = torch.linalg.vector_norm(ctx, dim=-1, dtype=torch.float32)
    valid = mask > 0
    inv = torch.where(valid, 1.0 / torch.clamp(norms, min=1e-12),
                      torch.zeros_like(norms))
    bias = torch.where(valid, torch.zeros_like(norms),
                       torch.full_like(norms, NEG_INF))
    return inv.contiguous(), bias.contiguous()


def sim_max_exact_plain(qn: torch.Tensor, ctx: torch.Tensor,
                        inv: torch.Tensor, bias: torch.Tensor
                        ) -> torch.Tensor:
    """max_l <qn[q], ctx[v, l]> * inv[v, l] + bias[v, l] in f32, in query
    chunks: the TPU kernel's arithmetic (f32 query against the raw frames,
    exact products, f32 sums, scale after the dot), with the products
    taken by an f32 matmul (allow_tf32 False on a GPU)."""
    nq, d = qn.shape
    nv, l_frames, _ = ctx.shape
    c2 = ctx.reshape(nv * l_frames, d).float()
    chunk = _query_chunk(nv, l_frames)
    out = torch.empty((nq, nv), dtype=torch.float32, device=qn.device)
    for s in range(0, nq, chunk):
        frame = (qn[s:s + chunk] @ c2.T).reshape(-1, nv, l_frames)
        out[s:s + chunk] = (frame * inv[None] + bias[None]).amax(dim=-1)
    return out


@traced("kernels/sim_max_exact")
def fused_exact_scores(query: torch.Tensor, ctx: torch.Tensor,
                       mask: torch.Tensor, plain: bool = False
                       ) -> torch.Tensor:
    """Exact-grade f32 cosine scores (Nq, Nv) of queries (any float dtype)
    against bf16-stored frames (Nv, L, D) with an (Nv, L) mask: the dense
    rescore engine. The query is L2-normalized in f32 and dotted with the
    raw frames; the reciprocal frame norm scales each frame score after
    the dot (a positive scale commutes with the max), ~1 f32 ulp from
    normalize-then-dot."""
    what = "fused_exact_scores"
    _frame_shapes(what, query, ctx, mask)
    if ctx.dtype != torch.bfloat16:
        raise ValueError(f"{what} needs bf16-stored frames, got {ctx.dtype}")
    dev = _same_device(what, query, ctx, mask)
    qn = l2_normalize(query.float()).contiguous()
    ctx = ctx.contiguous()
    inv, bias = exact_frame_scales(ctx, mask)
    if plain or dev.type == "cpu":
        return sim_max_exact_plain(qn, ctx, inv, bias)
    return sim_max_exact_launch(qn, ctx, inv, bias)


def sim_max_exact_launch(qn: torch.Tensor, ctx: torch.Tensor,
                         inv: torch.Tensor, bias: torch.Tensor
                         ) -> torch.Tensor:
    """The exact kernel alone on CUDA tensors: normalized f32 queries
    (Nq, D), bf16 frames (Nv, L, D) and the `exact_frame_scales` of the
    frames, all contiguous; same result as sim_max_exact_plain."""
    from dldkd_tpu_torch.ops.kernels.build import bind, check

    what = "sim_max_exact"
    _frame_shapes(what, qn, ctx, inv, bias)
    if qn.dtype != torch.float32 or ctx.dtype != torch.bfloat16 \
            or inv.dtype != torch.float32 or bias.dtype != torch.float32:
        raise ValueError(f"{what}: want f32 queries, bf16 frames, f32 "
                         f"scales")
    dev = _same_device(what, qn, ctx, inv, bias)
    if dev.type != "cuda":
        raise ValueError(f"{what}: the kernel runs on CUDA tensors")
    _contiguous(what, qn=qn, ctx=ctx, inv=inv, bias=bias)
    qn, ctx = pad_depth(8, qn, ctx)   # bf16 frame rows of 16-byte multiples
    _aligned16(what, qn=qn, ctx=ctx)
    nq, d = qn.shape
    if d > EXACT_MAX_DEPTH:
        raise ValueError(f"{what}: depth {d} above {EXACT_MAX_DEPTH}: the "
                         f"kernel keeps three bf16 parts of 64 query rows "
                         f"in shared memory")
    nv, l_frames, _ = ctx.shape
    out = torch.empty((nq, nv), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = bind("sim_max_mma", "sim_max_exact", 5, 4)(
            qn.data_ptr(), ctx.data_ptr(), inv.data_ptr(), bias.data_ptr(),
            out.data_ptr(), nq, nv, l_frames, d, stream)
    check(rc, what)
    LAUNCHES["sim_max_exact"] += 1
    return out
