"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with the CUDA toolkit (sm_90a) and skip
elsewhere. This file imports nothing of JAX, so on a machine without JAX
run it without the suite's conftest (which configures JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: scores 1e-5 abs (f32 scoring: 3xTF32 tensor-core products,
each within ~2^-22 of the f32 product, against the plain version's f32
matmul; bf16 scoring: tensor-core products of bf16 values, exact in f32,
summed with f32 accumulation in another order than the plain version's f32
matmul of the widened values); tower outputs 1e-4 abs in f32 (five chained
products, sums in another order) and 3e-2 abs in bf16 (the same rounding
points; another accumulation order flips a bf16 rounding now and then);
int8 scores bitwise on valid videos (integer sums); exact-rescore scores
5e-6 abs (split-3 bf16 products, exact, against the same stored frames,
summed in another order); both split kernels within 1e-6 of an f64
reference on the same inputs (f32 grade: one TF32 product alone is
~1e-4 off); the int8 epilogue bitwise (the plain version sums in the
kernel's order) and, through the towers, bitwise against the epilogue's
plain version applied to the same launch's frames. Both dtypes' towers
run the tensor-core kernels of csrc/tower_mma.cu: bf16 products exact in
f32, f32 products in 3xTF32 (f32-grade), sums in another order.
"""

import threading
import time

import pytest
import torch

import numpy as np

from dldkd_tpu_torch import serving
from dldkd_tpu_torch.config import ModelConfig
from dldkd_tpu_torch.data.ingest import PackedVideos
from dldkd_tpu_torch.models import DLDKD
from dldkd_tpu_torch.ops.fast_eval import tower_weights
from dldkd_tpu_torch.ops.kernels import build
from dldkd_tpu_torch.ops.kernels import query_tower as qt
from dldkd_tpu_torch.ops.kernels import sim_max
from dldkd_tpu_torch.ops.masking import l2_normalize

pytestmark = pytest.mark.cuda

TOWER_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _mask(n, l, gen, dev):
    lengths = torch.randint(1, l + 1, (n,), generator=gen)
    mask = (torch.arange(l)[None] < lengths[:, None]).float()
    mask[0] = 0.0                          # an all-masked row
    return mask.to(dev)


@pytest.fixture
def bound_symbols(monkeypatch):
    """(library, symbol) of every C entry the wrappers bind."""
    seen = []
    real = build.bind

    def spy(name, symbol, *arity):
        seen.append((name, symbol))
        return real(name, symbol, *arity)

    monkeypatch.setattr(build, "bind", spy)
    return seen


# Edges of the tensor-core kernels' tiling (64 queries per block, 128
# frames per chunk, 128 bytes of depth per stage, a persistent grid
# striding over the videos): query counts around the 64-row tile, video
# counts that no grid divides, one frame, a ragged chunk, two chunks, a
# depth that needs padding (bf16 rows to 16 bytes) and TVR's shapes. Every
# case has an all-masked video (column 0). f32 runs the 3xTF32 instance of
# the same kernel on the same shapes.
_SIM_MAX_SHAPES = [(50, 2179, 128, 384), (256, 2179, 128, 384),
                   (7, 13, 5, 24), (65, 9, 17, 40), (1, 13, 1, 24),
                   (64, 263, 7, 64), (65, 131, 130, 128),
                   (128, 37, 128, 384), (5, 11, 6, 20), (256, 19, 130, 72)]
_SIM_MAX_ENTRY = {torch.float32: ("sim_max_mma", "sim_max_f32"),
                  torch.bfloat16: ("sim_max_mma", "sim_max_bf16")}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq,nv,l_frames,d", _SIM_MAX_SHAPES)
def test_sim_max_kernel_matches_plain(dev, bound_symbols, dtype, nq, nv,
                                      l_frames, d):
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(nq, d, generator=gen).to(dev, dtype)
    ctx = torch.randn(nv, l_frames, d, generator=gen).to(dev, dtype)
    mask = _mask(nv, l_frames, gen, dev)
    qn, cn = l2_normalize(q).contiguous(), l2_normalize(ctx).contiguous()
    before = sim_max.LAUNCHES["sim_max"]
    got = sim_max.fused_clip_scores(qn, cn, mask)
    want = sim_max.sim_max_plain(qn, cn, mask)
    torch.cuda.synchronize()
    assert sim_max.LAUNCHES["sim_max"] == before + 1
    assert bound_symbols == [_SIM_MAX_ENTRY[dtype]]
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert bool((got[:, 0] <= -1e9).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("branches", [2, 1])
@pytest.mark.parametrize("kind", ["query", "context"])
def test_tower_kernels_match_plain(dev, dtype, branches, kind):
    gen = torch.Generator().manual_seed(1)
    cfg = ModelConfig(visual_input_size=72, query_input_size=40,
                      inheritance_hidden=96, exploration_hidden=96,
                      max_ctx_l=20, max_desc_l=11, n_heads=4,
                      double_branch=True, dtype=dtype)
    model = DLDKD(cfg).init_weights(torch.Generator().manual_seed(2))
    tdt = getattr(torch, dtype)
    ws = tower_weights(model, dev)[kind][:branches]
    n, l, d = (9, 11, 40) if kind == "query" else (5, 20, 72)
    x = torch.randn(n, l, d, generator=gen).to(dev)
    mask = _mask(n, l, gen, dev)
    if kind == "query":
        def run(plain):
            return qt.query_towers(x, mask, ws, 4, tdt, 11, "test", plain)
    else:
        def run(plain):
            return qt.context_towers(x, mask, ws, 4, tdt, "test", plain)
    before = qt.LAUNCHES[f"{kind}_tower"]
    got, want = run(False), run(True)
    torch.cuda.synchronize()
    assert qt.LAUNCHES[f"{kind}_tower"] == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert bool(torch.isfinite(g.float()).all())
        torch.testing.assert_close(g.float(), w.float(),
                                   atol=TOWER_TOL[tdt], rtol=0)


# Edges of the towers' tensor-core kernels (csrc/tower_mma.cu), both dtypes:
# rows M = N * L around the 64- and 128-row GEMM tiles (1, 63, 64, 65, 129),
# depth K = 40 and 72 (multiples of 8, not of 16: a zero-filled last bf16
# k-step), hidden 96 (d_head 24) and 384 (d_head 96), and hidden 40 (d_head
# 10, padded to 16 inside the packed operands); sequences of 1, 11 (padded
# to 16 on the query grid), 20, 43 and 128 rows (one key tile), 136 and 300
# (two and three key tiles of 128: the softmax's max and sum over every
# tile first); an input width and hidden size that are not multiples of 8
# (44 and 36: 4 heads of 9 dims); one 256-dim head (key tiles of 64). The
# whole-row products (LayerNorm and pooling in the epilogue): query
# sequences of 24 and 40 rows (64 rows hold two and one of them), 64 and
# 72 (one row tile, two), hidden 520 (a cluster of five 128-column
# blocks) and 1,032 (two passes of the eight-block cluster, the rows
# through L2). Each case has an all-masked row.
# (kind, n, l, d, hidden, heads): positional tables of l rows
_TOWER_EDGES = [("context", 1, 1, 72, 96, 4), ("context", 7, 9, 40, 96, 4),
                ("context", 4, 16, 72, 96, 4), ("context", 13, 5, 40, 96, 4),
                ("context", 3, 43, 72, 96, 4), ("query", 9, 11, 40, 96, 4),
                ("context", 5, 20, 72, 96, 4),
                ("context", 2, 128, 72, 384, 4),
                ("query", 65, 20, 40, 384, 4), ("context", 5, 20, 72, 40, 4),
                ("query", 9, 11, 40, 40, 4), ("context", 3, 136, 72, 96, 4),
                ("query", 3, 136, 40, 96, 4), ("context", 2, 300, 72, 96, 4),
                ("query", 2, 300, 40, 96, 4), ("context", 6, 20, 44, 36, 4),
                ("query", 9, 11, 44, 36, 4), ("context", 4, 20, 48, 256, 1),
                ("query", 9, 11, 48, 256, 1), ("query", 7, 24, 40, 96, 4),
                ("query", 5, 40, 40, 96, 4), ("query", 3, 64, 40, 96, 4),
                ("query", 3, 72, 40, 96, 4), ("query", 5, 20, 40, 520, 4),
                ("context", 3, 20, 72, 520, 4),
                ("query", 2, 136, 40, 520, 4),
                ("query", 3, 16, 40, 1032, 8),
                ("context", 2, 16, 40, 1032, 8)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("branches", [2, 1])
@pytest.mark.parametrize("kind,n,l,d,hidden,heads", _TOWER_EDGES)
def test_tower_tiling_edges_match_plain(dev, dtype, branches, kind, n, l, d,
                                        hidden, heads):
    gen = torch.Generator().manual_seed(9)
    cfg = ModelConfig(visual_input_size=d, query_input_size=d,
                      inheritance_hidden=hidden, exploration_hidden=hidden,
                      max_ctx_l=l, max_desc_l=l, n_heads=heads,
                      double_branch=True, dtype=dtype)
    model = DLDKD(cfg).init_weights(torch.Generator().manual_seed(2))
    tdt = getattr(torch, dtype)
    tw = tower_weights(model, dev)
    ws = tw[kind][:branches]
    packed = tw["packed"][kind][0] if branches == 2 else None
    x = torch.randn(n, l, d, generator=gen).to(dev)
    mask = _mask(n, l, gen, dev)
    if kind == "query":
        def run(plain):
            return qt.query_towers(x, mask, ws, heads, tdt, l, "test", plain,
                                   packed)
    else:
        def run(plain):
            return qt.context_towers(x, mask, ws, heads, tdt, "test", plain,
                                     packed=packed)
    before = qt.LAUNCHES[f"{kind}_tower"]
    got, want = run(False), run(True)
    torch.cuda.synchronize()
    assert qt.LAUNCHES[f"{kind}_tower"] == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert bool(torch.isfinite(g.float()).all())
        torch.testing.assert_close(g.float(), w.float(),
                                   atol=TOWER_TOL[tdt], rtol=0)


# The ActivityNet and Charades scripts' widths (scripts/torch/
# do_activitynet.sh, do_charades.sh): query and I3D video features 1,024
# wide, hidden 384 x 2, 4 heads, 30 tokens and 128 frames; the eval's 50
# queries, serving's 256 and the eval's 200-video batch, both branches in
# one launch on weights packed once.
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,n", [("query", 50), ("query", 256),
                                    ("context", 200)])
def test_towers_at_width_1024_match_plain(dev, dtype, kind, n):
    gen = torch.Generator().manual_seed(17)
    cfg = ModelConfig(visual_input_size=1024, query_input_size=1024,
                      inheritance_hidden=384, exploration_hidden=384,
                      max_ctx_l=128, max_desc_l=30, n_heads=4,
                      double_branch=True, dtype=dtype)
    model = DLDKD(cfg).init_weights(torch.Generator().manual_seed(2))
    tdt = getattr(torch, dtype)
    tw = tower_weights(model, dev)
    ws, packed = tw[kind], tw["packed"][kind][0]
    l = 30 if kind == "query" else 128
    x = torch.randn(n, l, 1024, generator=gen)
    x = (x / x.norm(dim=-1, keepdim=True)).to(dev)
    mask = _mask(n, l, gen, dev)
    if kind == "query":
        def run(plain):
            return qt.query_towers(x, mask, ws, 4, tdt, l, "test", plain,
                                   packed)
    else:
        def run(plain):
            return qt.context_towers(x, mask, ws, 4, tdt, "test", plain,
                                     packed=packed)
    before = qt.LAUNCHES[f"{kind}_tower"]
    got, want = run(False), run(True)
    torch.cuda.synchronize()
    assert qt.LAUNCHES[f"{kind}_tower"] == before + 1
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert bool(torch.isfinite(g.float()).all())
        torch.testing.assert_close(g.float(), w.float(),
                                   atol=TOWER_TOL[tdt], rtol=0)


# one chain for both dtypes: the tensor-core entries of csrc/tower_mma.cu,
# the LayerNorms and the pooling in the whole-row products' epilogues
# (tower_gemm_ln), and no SIMT product
_TOWER_ENTRIES = {("tower_mma", "tower_normalize"),
                  ("tower_mma", "tower_gemm_mma"),
                  ("tower_mma", "tower_gemm_ln"),
                  ("tower_mma", "tower_attention_mma")}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_towers_bind_their_dtype_entries(dev, bound_symbols, dtype):
    """f32 and bf16 towers run the same tensor-core entries of
    csrc/tower_mma.cu (f32 in 3xTF32), LayerNorm and pooling in the
    products' epilogues; nothing of csrc/tower.cu (the int8 epilogue)."""
    gen = torch.Generator().manual_seed(10)
    cfg = ModelConfig(visual_input_size=72, query_input_size=40,
                      inheritance_hidden=96, exploration_hidden=96,
                      max_ctx_l=20, max_desc_l=11, n_heads=4,
                      double_branch=True, dtype=dtype)
    model = DLDKD(cfg).init_weights(torch.Generator().manual_seed(2))
    tw = tower_weights(model, dev)
    tdt = getattr(torch, dtype)
    x = torch.randn(5, 11, 40, generator=gen).to(dev)
    qt.query_towers(x, _mask(5, 11, gen, dev), tw["query"], 4, tdt, 11,
                    "test", packed=tw["packed"]["query"][0])
    torch.cuda.synchronize()
    assert set(bound_symbols) == _TOWER_ENTRIES


def _device_kernels(fn):
    """Names of the CUDA kernels fn() runs on the card (torch.profiler),
    copies and fills apart."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset"))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,emit_q8,want", [("query", False, 5),
                                               ("context", False, 6),
                                               ("context", True, 7)])
def test_tower_chain_launches(dev, dtype, kind, emit_q8, want):
    """One tower launch runs 5 kernels (query), 6 (video) or 7 (video with
    the int8 epilogue): normalize, the projection with its LayerNorm, Q|K|V,
    attention, the output product with its LayerNorm (and the query
    tower's pooling), out_mapping, the int8 epilogue; no separate
    LayerNorm or pooling kernel."""
    cfg = ModelConfig(visual_input_size=72, query_input_size=40,
                      inheritance_hidden=96, exploration_hidden=96,
                      max_ctx_l=20, max_desc_l=16, n_heads=4,
                      double_branch=True, dtype=dtype)
    model = DLDKD(cfg).init_weights(torch.Generator().manual_seed(2))
    tw = tower_weights(model, dev)
    gen = torch.Generator().manual_seed(4)
    n, l, d = (5, 16, 40) if kind == "query" else (5, 20, 72)
    x = torch.randn(n, l, d, generator=gen).to(dev)
    mask = _mask(n, l, gen, dev)
    names = _device_kernels(lambda: qt.tower_cuda(
        x, mask, tw["packed"][kind][0], 4, getattr(torch, dtype), kind,
        emit_q8=emit_q8))
    assert len(names) == want, names
    assert not any("layernorm_kernel" in k or "pool_kernel" in k
                   for k in names)
    assert sum("gemm_rows_kernel" in k for k in names) == 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_towers_compute_at_l_136(dev, dtype):
    """136 frames, past the 128 rows the attention once held whole: two key
    tiles and two query tiles, through the kernels, within the tower
    tolerance of the plain version; and a query tower of 136 tokens, whose
    pooling walks three 64-row tiles of each sequence."""
    cfg = ModelConfig(visual_input_size=72, query_input_size=40,
                      inheritance_hidden=96, exploration_hidden=96,
                      max_ctx_l=136, max_desc_l=136, n_heads=4,
                      double_branch=True, dtype=dtype)
    model = DLDKD(cfg).init_weights(torch.Generator().manual_seed(2))
    tdt = getattr(torch, dtype)
    tw = tower_weights(model, dev)
    gen = torch.Generator().manual_seed(13)
    x = torch.randn(2, 136, 72, generator=gen).to(dev)
    mask = _mask(2, 136, gen, dev)
    before = qt.LAUNCHES["context_tower"]
    got = qt.context_towers(x, mask, tw["context"], 4, tdt, "test")
    want = qt.context_towers(x, mask, tw["context"], 4, tdt, "test",
                             plain=True)
    torch.cuda.synchronize()
    assert qt.LAUNCHES["context_tower"] == before + 1
    xq = torch.randn(3, 136, 40, generator=gen).to(dev)
    mq = _mask(3, 136, gen, dev)
    before = qt.LAUNCHES["query_tower"]
    got += qt.query_towers(xq, mq, tw["query"], 4, tdt, 136, "test")
    want += qt.query_towers(xq, mq, tw["query"], 4, tdt, 136, "test",
                            plain=True)
    torch.cuda.synchronize()
    assert qt.LAUNCHES["query_tower"] == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(),
                                   atol=TOWER_TOL[tdt], rtol=0)


def test_kernel_wrappers_reject_bad_inputs(dev):
    q = torch.randn(4, 8, device=dev)
    ctx = torch.randn(3, 5, 8, device=dev)
    mask = torch.ones(3, 5, device=dev)
    with pytest.raises(ValueError, match="several devices"):
        sim_max.fused_clip_scores(q, ctx, mask.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        sim_max.fused_clip_scores(q, ctx.transpose(0, 1).contiguous()
                                  .transpose(0, 1), mask)


_SCORE_SHAPES = [(256, 2179, 128, 384), (50, 2179, 128, 384), (7, 13, 5, 24),
                 (65, 9, 17, 40), (5, 11, 6, 22)]
# the tiling edges of _SIM_MAX_SHAPES for int8 rows (padded to 16 bytes:
# D = 22, 24, 40, 72)
_INT8_SHAPES = _SCORE_SHAPES + [(1, 13, 1, 16), (64, 263, 7, 64),
                                (65, 131, 130, 128), (128, 37, 128, 384),
                                (256, 19, 130, 72)]


@pytest.mark.parametrize("nq,nv,l_frames,d", _INT8_SHAPES)
def test_int8_kernel_matches_plain(dev, nq, nv, l_frames, d):
    gen = torch.Generator().manual_seed(3)
    q8 = torch.randint(-127, 128, (nq, d), generator=gen,
                       dtype=torch.int8).to(dev)
    c8 = torch.randint(-127, 128, (nv, l_frames, d), generator=gen,
                       dtype=torch.int8).to(dev)
    mask = _mask(nv, l_frames, gen, dev)
    bias = sim_max.q8_index_bias(mask)
    before = sim_max.LAUNCHES["sim_max_int8"]
    got = sim_max.fused_clip_scores_int8(q8, c8, bias)
    want = sim_max.fused_clip_scores_int8(q8, c8, bias, plain=True)
    torch.cuda.synchronize()
    assert sim_max.LAUNCHES["sim_max_int8"] == before + 1
    valid = mask.max(dim=1).values > 0
    assert torch.equal(got[:, valid], want[:, valid])
    assert bool((got[:, ~valid] < -6e4).all())


@pytest.mark.parametrize("nq,nv,l_frames,d", _SCORE_SHAPES)
def test_exact_kernel_matches_plain(dev, nq, nv, l_frames, d):
    gen = torch.Generator().manual_seed(4)
    q = torch.randn(nq, d, generator=gen).to(dev)
    ctx = (3 * torch.randn(nv, l_frames, d, generator=gen)).to(
        dev, torch.bfloat16)
    mask = _mask(nv, l_frames, gen, dev)
    before = sim_max.LAUNCHES["sim_max_exact"]
    got = sim_max.fused_exact_scores(q, ctx, mask)
    want = sim_max.fused_exact_scores(q, ctx, mask, plain=True)
    torch.cuda.synchronize()
    assert sim_max.LAUNCHES["sim_max_exact"] == before + 1
    torch.testing.assert_close(got, want, atol=5e-6, rtol=0)
    assert bool((got[:, 0] <= -1e9).all())


# Edges of the split kernels (f32 scoring in 3xTF32, exact rescoring in
# split-3 bf16): query counts around the 64-query tiles and serving's 256,
# frame counts around the 128-frame chunk and over two chunks, a depth of
# one and a half f32 stages (48), one that needs padding (100: f32 rows to
# 4 values, bf16 frame rows to 8) and TVR's 384; 23 videos, which no grid
# divides, column 0 all-masked.
_SPLIT_NQ = (1, 50, 64, 65, 256)
_SPLIT_L = (1, 127, 128, 129, 300)
_SPLIT_D = (48, 100, 384)


def _split_inputs(nq, l_frames, d, dev, nv=23):
    gen = torch.Generator().manual_seed(nq * 1000 + l_frames + d)
    q = torch.randn(nq, d, generator=gen).to(dev)
    ctx = torch.randn(nv, l_frames, d, generator=gen).to(dev)
    return q, ctx, _mask(nv, l_frames, gen, dev)


def _f64_scores(q, c, mask, inv=None, bias=None):
    """The scorers' function in f64 on the same inputs: the reference that
    shows f32-grade error."""
    s = torch.einsum("qd,vld->qvl", q.double(), c.double())
    if inv is None:
        m = mask.double()
        s = s * m + (1 - m) * -1e10
    else:
        s = s * inv.double() + bias.double()
    return s.amax(dim=-1)


def _valid_err(got, ref, mask):
    valid = mask.amax(dim=1) > 0
    return float((got.double() - ref)[:, valid].abs().max())


@pytest.mark.parametrize("d", _SPLIT_D)
@pytest.mark.parametrize("l_frames", _SPLIT_L)
@pytest.mark.parametrize("nq", _SPLIT_NQ)
def test_f32_split_kernel_edges(dev, bound_symbols, nq, l_frames, d):
    q, ctx, mask = _split_inputs(nq, l_frames, d, dev)
    qn, cn = l2_normalize(q).contiguous(), l2_normalize(ctx).contiguous()
    before = sim_max.LAUNCHES["sim_max"]
    got = sim_max.fused_clip_scores(qn, cn, mask)
    want = sim_max.sim_max_plain(qn, cn, mask)
    torch.cuda.synchronize()
    assert sim_max.LAUNCHES["sim_max"] == before + 1
    assert bound_symbols == [("sim_max_mma", "sim_max_f32")]
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert _valid_err(got, _f64_scores(qn, cn, mask), mask) <= 1e-6
    assert bool((got[:, 0] <= -1e9).all())


@pytest.mark.parametrize("d", _SPLIT_D)
@pytest.mark.parametrize("l_frames", _SPLIT_L)
@pytest.mark.parametrize("nq", _SPLIT_NQ)
def test_exact_split_kernel_edges(dev, bound_symbols, nq, l_frames, d):
    q, ctx, mask = _split_inputs(nq, l_frames, d, dev)
    ctx = (3 * ctx).to(torch.bfloat16)
    before = sim_max.LAUNCHES["sim_max_exact"]
    got = sim_max.fused_exact_scores(q, ctx, mask)
    want = sim_max.fused_exact_scores(q, ctx, mask, plain=True)
    torch.cuda.synchronize()
    assert sim_max.LAUNCHES["sim_max_exact"] == before + 1
    assert bound_symbols == [("sim_max_mma", "sim_max_exact")]
    torch.testing.assert_close(got, want, atol=5e-6, rtol=0)
    inv, bias = sim_max.exact_frame_scales(ctx, mask)
    ref = _f64_scores(l2_normalize(q), ctx, mask, inv, bias)
    assert _valid_err(got, ref, mask) <= 1e-6
    assert bool((got[:, 0] <= -1e9).all())


def test_f32_split_small_terms_matter(dev):
    """Queries and frames whose every value has low mantissa bits set, so
    no value is a TF32 number: the product of the TF32 parts alone is
    ~1e-5 off; the kernel, with its small terms, stays within 1e-6 of
    f64."""
    gen = torch.Generator().manual_seed(12)

    def rough(x):   # low 12 bits of every mantissa set
        return (l2_normalize(x).view(torch.int32) | 0xFFF).view(
            torch.float32).to(dev).contiguous()

    q = rough(torch.randn(65, 384, generator=gen))
    c = rough(torch.randn(37, 129, 384, generator=gen))
    mask = _mask(37, 129, gen, dev)
    got = sim_max.fused_clip_scores(q, c, mask)
    ref = _f64_scores(q, c, mask)
    big_only = _f64_scores(sim_max.split_tf32(q)[0],
                           sim_max.split_tf32(c)[0], mask)
    err, err_big = _valid_err(got, ref, mask), _valid_err(big_only, ref,
                                                          mask)
    assert err <= 1e-6 and err_big >= 10 * err and err_big > 2e-6


def _kernel_names(fn):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


@pytest.mark.parametrize("kind,nq,instance", [
    ("exact", 256, "Exact, 1>"), ("exact", 50, "Exact, 1>"),
    ("f32", 256, "Tf32, 2>"), ("f32", 50, "Tf32, 1>")])
def test_split_kernels_warpgroups_per_block(dev, kind, nq, instance):
    """exact keeps three bf16 parts of its query rows in shared memory, so
    its launch takes one warpgroup (64 queries) per block even at 256
    queries; f32 stages its queries through the ring and takes two."""
    q, ctx, mask = _split_inputs(nq, 128, 384, dev)
    if kind == "exact":
        ctx = ctx.to(torch.bfloat16)
        names = _kernel_names(lambda: sim_max.fused_exact_scores(q, ctx,
                                                                 mask))
    else:
        qn, cn = l2_normalize(q).contiguous(), l2_normalize(ctx).contiguous()
        names = _kernel_names(lambda: sim_max.fused_clip_scores(qn, cn,
                                                                mask))
    mine = [n for n in names if "sim_max_mma_kernel" in n]
    assert len(mine) == 1 and instance in mine[0], names


def test_exact_kernel_rejects_depth_above_its_limit(dev):
    d = sim_max.EXACT_MAX_DEPTH + 8
    q = torch.randn(3, d, device=dev)
    ctx = torch.randn(2, 5, d, device=dev).to(torch.bfloat16)
    with pytest.raises(ValueError, match="depth"):
        sim_max.fused_exact_scores(q, ctx, torch.ones(2, 5, device=dev))


@pytest.mark.parametrize("h", [384, 40, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_epilogue_kernel_matches_plain(dev, dtype, h):
    gen = torch.Generator().manual_seed(5)
    x = (2 * torch.randn(1000, h, generator=gen)).to(dev, dtype)
    x[3] = 0.0
    before = qt.LAUNCHES["context_tower_q8"]
    got = qt.quantize_frames_q8(x)
    want = qt.quantize_frames_q8(x, plain=True)
    torch.cuda.synchronize()
    assert qt.LAUNCHES["context_tower_q8"] == before + 1
    assert got.dtype == torch.int8 and torch.equal(got, want)


def _q8_scaled(x):
    """xn * 127 of each value, at the plain epilogue's rounding points
    (quantize_frames_q8_plain before its rint and clamp)."""
    dt = x.dtype
    s = qt._warp_order_sum((x * x).float()).to(dt).float()
    norm = torch.sqrt(s).to(dt).float()
    return (x.float() / torch.clamp(norm, min=1e-12)).to(dt).float() * 127


def _q8_edge_rows(m, h, dtype, dev, seed):
    """m rows of width h: seeded values, an all-zero row and a row of
    1e-13 (norms under 1e-12, the clamp), rows whose norm is twice each
    value (xn = +-0.5: xn * 127 on the tie 63.5) and rows of one value (xn
    = +-1: xn * 127 = +-127); asserts that the ties are there. Finite rows
    never pass +-127: each rounding is monotone, so the norm is at least
    every |x| of its row (the clamp past +-127.5 takes non-finite rows:
    test_int8_epilogue_non_finite_rows)."""
    gen = torch.Generator().manual_seed(seed)
    x = 2 * torch.randn(m, h, generator=gen)
    x[m // 2] = 0.0
    for i in range(1, 9):                   # the ties, either sign
        x[i] = 0.0
        x[i, :4] = (-1) ** i * torch.rand(1, generator=gen).item() * 3
    one = torch.exp(torch.randn(40, generator=gen) * 3)
    x[9:49] = 0.0
    x[9:49, 0] = one * torch.where(torch.arange(40) % 2 == 0, 1.0, -1.0)
    x[49] = 1e-13                           # a norm under 1e-12
    x = x.to(dev, dtype)
    t = _q8_scaled(x)
    assert bool((t.abs() == 63.5).any()), "no tie"
    assert bool((t.abs() == 127).any()) and bool((t.abs() <= 127).all())
    return x


@pytest.mark.parametrize("h", [48, 60, 100, 384, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_epilogue_edge_rows_bitwise(dev, dtype, h):
    """In place, every width the kernel's paths split on (16-byte copies
    and stores at 48, 384, 1,024; a row start not 16-byte aligned at 60 and
    100), a row count that leaves the last block and the grid's last pass
    partial, the clamp, the ties and the saturation: bitwise the plain
    version."""
    x = _q8_edge_rows(20_011, h, dtype, dev, seed=h)
    got = qt.quantize_frames_q8(x)
    torch.cuda.synchronize()
    assert torch.equal(got, qt.quantize_frames_q8_plain(x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_epilogue_unaligned_rows_bitwise(dev, dtype):
    """At 384, input and output that start off a 16-byte boundary (one
    value and one byte in): the value-by-value copies and the byte
    stores, bitwise the plain version."""
    m, h = 1003, 384
    x = _q8_edge_rows(m, h, dtype, dev, seed=7)
    xb = torch.empty(m * h + 1, dtype=dtype, device=dev)
    xu = xb[1:].view(m, h)
    xu.copy_(x)
    yb = torch.full((m * h + 1,), 77, dtype=torch.int8, device=dev)
    yu = yb[1:].view(m, h)
    qt._launch_quantize(xu, yu, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert int(yb[0]) == 77
    assert torch.equal(yu, qt.quantize_frames_q8_plain(x))


@pytest.mark.parametrize("h", [48, 60, 100, 384, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_epilogue_transposed_bitwise(dev, dtype, h):
    """The transposed write alone on (G, N seq_l, hp) rows (hp = h padded
    to 8, zeros past h) into (G, l_p, nv_p, h) at a video offset: every
    written row bitwise the plain epilogue's, permuted; nothing else
    written."""
    g_n, n, seq_l, l_p, nv_p, v_off = 2, 37, 9, 12, 50, 5
    hp = -(-h // 8) * 8
    rows = _q8_edge_rows(g_n * n * seq_l, h, dtype, dev, seed=h + 1)
    y = torch.zeros(g_n, n * seq_l, hp, dtype=dtype, device=dev)
    y[..., :h] = rows.view(g_n, n * seq_l, h)
    out = torch.full((g_n, l_p, nv_p, h), 77, dtype=torch.int8, device=dev)
    before = qt.LAUNCHES["context_tower_q8_t"]
    qt._launch_quantize_t(y, h, seq_l, out, v_off,
                          torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert qt.LAUNCHES["context_tower_q8_t"] == before + 1
    want = torch.full_like(out, 77)
    q8 = qt.quantize_frames_q8_plain(rows).view(g_n, n, seq_l, h)
    want[:, :seq_l, v_off:v_off + n] = q8.permute(0, 2, 1, 3)
    assert torch.equal(out, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_epilogue_non_finite_rows(dev, dtype):
    """Rows with an inf or a NaN, where the plain version's torch.clamp
    keeps the NaN and the kernel keeps its fmaxf: an inf makes the norm inf
    (inf / inf is NaN: -127; finite / inf is 0); a NaN makes it NaN, which
    fmaxf clamps to 1e-12 (the NaN gives -127, +-1 / 1e-12 saturates at
    +-127)."""
    x = torch.zeros(3, 384, dtype=dtype, device=dev)
    x[0, :2] = torch.tensor([float("inf"), 1.0])
    x[1, :2] = torch.tensor([-float("inf"), -1.0])
    x[2, :3] = torch.tensor([float("nan"), 1.0, -1.0])
    want = torch.zeros(3, 384, dtype=torch.int8)
    want[0, 0] = want[1, 0] = -127
    want[2, :3] = torch.tensor([-127, 127, -127])
    got = qt.quantize_frames_q8(x)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


def test_int8_epilogue_reciprocal_exhaustive(dev):
    """The bf16 epilogue's one reciprocal a row gives the divide's bf16
    quotient for every bf16 value against every bf16 norm (2^32 pairs,
    the 1e-12 clamp included)."""
    assert qt.q8_reciprocal_mismatches(dev) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("branches", [2, 1])
def test_context_tower_q8_matches_plain(dev, dtype, branches):
    """The towers with emit_q8 write the epilogue of their own frames; and
    stay within one level of the plain towers' int8 rows."""
    gen = torch.Generator().manual_seed(6)
    cfg = ModelConfig(visual_input_size=72, query_input_size=40,
                      inheritance_hidden=96, exploration_hidden=96,
                      max_ctx_l=20, max_desc_l=11, n_heads=4,
                      double_branch=True, dtype=dtype)
    model = DLDKD(cfg).init_weights(torch.Generator().manual_seed(2))
    tdt = getattr(torch, dtype)
    ws = tower_weights(model, dev)["context"][:branches]
    x = torch.randn(5, 20, 72, generator=gen).to(dev)
    mask = _mask(5, 20, gen, dev)
    before = dict(qt.LAUNCHES)
    got = qt.context_towers(x, mask, ws, 4, tdt, "test", emit_q8=True)
    torch.cuda.synchronize()
    assert qt.LAUNCHES["context_tower"] == before["context_tower"] + 1
    assert qt.LAUNCHES["context_tower_q8"] == before["context_tower_q8"] + 1
    frames = qt.context_towers(x, mask, ws, 4, tdt, "test")
    plain = qt.context_towers(x, mask, ws, 4, tdt, "test", plain=True,
                              emit_q8=True)
    for g, f, p in zip(got, frames, plain):
        assert g.dtype == torch.int8 and g.shape == f.shape
        assert torch.equal(g, qt.quantize_frames_q8_plain(f))
        assert int((g.int() - p.int()).abs().max()) <= 1


@pytest.mark.parametrize("kw", [
    dict(), dict(score_quant=True), dict(score_quant=True, rescore=False),
    dict(index_store="raw", stream_block=16),
    dict(index_store="raw", stream_block=16, score_quant=True),
    dict(index_store="raw", stream_block=16, score_quant=True,
         rescore=False)],
    ids=["exact", "two_stage", "int8", "raw_exact", "raw_two_stage",
         "raw_int8"])
def test_retriever_on_card_matches_plain(dev, kw, monkeypatch):
    """Each serving route on either store on the card against the same
    Retriever running every kernel's plain version on the card (f32:
    equal ids); the raw store in blocks that do not divide the corpus."""
    monkeypatch.setenv("DLDKD_DENSE_RESCORE", "always")
    cfg = ModelConfig(visual_input_size=48, query_input_size=32,
                      inheritance_hidden=64, exploration_hidden=64,
                      max_ctx_l=16, max_desc_l=8, n_heads=4,
                      double_branch=True)
    model = DLDKD(cfg).init_weights(torch.Generator().manual_seed(7))
    rng = np.random.RandomState(8)
    videos = PackedVideos(feats=rng.randn(40, 16, 48).astype(np.float32),
                          mask=np.ones((40, 16), np.float32),
                          ids=[f"v{i}" for i in range(40)])
    qf = rng.randn(30, 8, 32).astype(np.float32)
    qm = np.ones((30, 8), np.float32)
    out = []
    for plain in (False, True):
        r = serving.Retriever(model, query_bsz=16, device="cuda",
                              plain=plain, **kw)
        r.index(videos, context_bsz=16)
        out.append(r.search(qf, qm, k=7))
    np.testing.assert_array_equal(out[0][1], out[1][1])
    np.testing.assert_allclose(out[0][0], out[1][0], atol=1e-4, rtol=0)


def _host_padded_batches(self, q_feats, q_mask):
    """Serving's staging before its pinned slots: each batch zero-padded
    on the host by np.concatenate, then a pageable copy to the card."""
    bsz = self.query_bsz
    for start in range(0, q_feats.shape[0], bsz):
        f = np.asarray(q_feats[start:start + bsz], np.float32)
        m = np.asarray(q_mask[start:start + bsz], np.float32)
        pad = bsz - f.shape[0]
        if pad:
            f = np.concatenate([f, np.zeros((pad,) + f.shape[1:], f.dtype)])
            m = np.concatenate([m, np.zeros((pad,) + m.shape[1:], m.dtype)])
        yield (torch.from_numpy(f).to(self.device),
               torch.from_numpy(m).to(self.device))


@pytest.mark.parametrize("kw", [
    dict(), dict(score_quant=True), dict(index_store="raw", stream_block=16)],
    ids=["exact", "two_stage", "raw_exact"])
def test_staged_search_past_the_inflight_batches_is_bitwise(dev, kw,
                                                           monkeypatch):
    """A search of more than _SEARCH_INFLIGHT_BATCHES x query_bsz ragged
    queries on the card, its batches staged through the two pinned slots
    while earlier batches' kernels are still queued: scores and ids
    bitwise those of the host-padded pageable batches; then a search of 3
    queries (a batch of 13 zeroed rows) likewise."""
    monkeypatch.setenv("DLDKD_DENSE_RESCORE", "always")
    cfg = ModelConfig(visual_input_size=48, query_input_size=32,
                      inheritance_hidden=64, exploration_hidden=64,
                      max_ctx_l=16, max_desc_l=8, n_heads=4,
                      double_branch=True)
    model = DLDKD(cfg).init_weights(torch.Generator().manual_seed(27))
    rng = np.random.RandomState(28)
    videos = PackedVideos(feats=rng.randn(40, 16, 48).astype(np.float32),
                          mask=np.ones((40, 16), np.float32),
                          ids=[f"v{i}" for i in range(40)])
    n = serving._SEARCH_INFLIGHT_BATCHES * 16 + 37
    qf = rng.randn(n, 8, 32).astype(np.float32)
    qm = (np.arange(8)[None] < rng.randint(1, 9, n)[:, None]
          ).astype(np.float32)
    r = serving.Retriever(model, query_bsz=16, device="cuda", **kw)
    r.index(videos, context_bsz=16)
    for f, m in ((qf, qm), (qf[-3:], qm[-3:])):
        got = r.search(f, m, k=7)
        with monkeypatch.context() as mp:
            mp.setattr(serving.Retriever, "_query_batches",
                       _host_padded_batches)
            want = r.search(f, m, k=7)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
    assert all(b.is_pinned() for s in r._slots for b in s.bufs)


# ------------------------------------------------------------ training

_TRAIN_CFG = dict(visual_input_size=48, query_input_size=32,
                  inheritance_hidden=64, exploration_hidden=64, max_ctx_l=16,
                  max_desc_l=8, n_heads=4, double_branch=True,
                  label_style="soft", input_drop=0.0, drop=0.0, margin=0.1,
                  use_hard_negative=True, hard_pool_size=1)


def _train_batch(rng, caps=(5, 4, 3, 3, 2, 1), q_pad=24):
    """A loader-shaped batch: videos by caption count, captions
    video-major, padded queries with label -1, ragged masks."""
    nv, n_q = len(caps), sum(caps)
    vmask = (np.arange(16)[None] < rng.randint(4, 17, nv)[:, None]
             ).astype(np.float32)
    tmask = (np.arange(8)[None] < rng.randint(2, 9, q_pad)[:, None]
             ).astype(np.float32)
    tmask[n_q:] = 0
    labels = np.full(q_pad, -1, np.int32)
    labels[:n_q] = np.repeat(np.arange(nv), caps)
    unit = lambda x: x / np.linalg.norm(x, axis=-1, keepdims=True)  # noqa
    return {
        "student_videos": (unit(rng.randn(nv, 16, 48)) * vmask[..., None]
                           ).astype(np.float32),
        "student_videos_mask": vmask,
        "teacher_videos": (rng.randn(nv, 16, 12) * vmask[..., None]
                           ).astype(np.float32),
        "student_text": (unit(rng.randn(q_pad, 8, 32)) * tmask[..., None]
                         ).astype(np.float32),
        "student_text_mask": tmask,
        "teacher_text": rng.randn(q_pad, 12).astype(np.float32),
        "text_labels": labels,
    }


def _step_on(device, sd, batch, cfg):
    from dldkd_tpu_torch import train
    from dldkd_tpu_torch.config import TrainConfig
    from dldkd_tpu_torch.optim import BertAdam, default_wd_mask

    torch.set_float32_matmul_precision("highest")
    model = DLDKD(cfg).to(device)
    model.load_state_dict(sd)
    named = dict(model.named_parameters())
    opt = BertAdam(named, 3e-4, None, wd_mask=default_wd_mask(named))
    tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    scal = train.LossScalars(*(torch.tensor(v, device=device)
                               for v in (0.95, 0.8, 0.8)))
    losses = train.train_step(model, cfg, TrainConfig(grad_clip=1.0), opt,
                              tb, torch.Generator(device=device), scal)
    return ({k: float(v) for k, v in losses.items()},
            {k: v.detach().cpu() for k, v in model.state_dict().items()})


def test_train_step_on_card_matches_cpu(dev):
    """One train step (forward, backward, the global clip, BertAdam) on
    the card against the same step on the CPU from the same state and
    batch, dropout 0, hard negatives from a pool of 1: losses within 1e-4,
    parameters within 1e-5 (f32 on both, sums in another order)."""
    cfg = ModelConfig(**_TRAIN_CFG)
    sd = DLDKD(cfg).init_weights(torch.Generator().manual_seed(3)
                                 ).state_dict()
    batch = _train_batch(np.random.RandomState(4))
    cpu_losses, cpu_sd = _step_on(torch.device("cpu"), sd, batch, cfg)
    gpu_losses, gpu_sd = _step_on(dev, sd, batch, cfg)
    for k, v in cpu_losses.items():
        assert abs(gpu_losses[k] - v) <= 1e-4, (k, gpu_losses[k], v)
    moved = 0
    for k, v in cpu_sd.items():
        torch.testing.assert_close(gpu_sd[k], v, atol=1e-5, rtol=0)
        moved += int(not torch.equal(v, sd[k]))
    assert moved > 0


def test_validation_on_card_matches_plain_on_trained_model(dev):
    """A tiny model trained a few steps on the card, then validated: the
    kernel path's score matrices within the f32 eval tolerance (1e-4) of
    the plain path's on the card, and fused SumR equal."""
    from dldkd_tpu_torch import evaluate, train
    from dldkd_tpu_torch.config import TrainConfig
    from dldkd_tpu_torch.data.ingest import PackedQueries
    from dldkd_tpu_torch.metrics import build_gt_indices
    from dldkd_tpu_torch.optim import BertAdam, default_wd_mask

    cfg = ModelConfig(**_TRAIN_CFG)
    model = DLDKD(cfg).init_weights(torch.Generator().manual_seed(5)).to(dev)
    named = dict(model.named_parameters())
    opt = BertAdam(named, 1e-3, None, wd_mask=default_wd_mask(named))
    rng = np.random.RandomState(6)
    scal = train.LossScalars(*(torch.tensor(v, device=dev)
                               for v in (0.95, 0.8, 0.8)))
    for _ in range(20):
        tb = {k: torch.from_numpy(v).to(dev)
              for k, v in _train_batch(rng).items()}
        train.train_step(model, cfg, TrainConfig(), opt, tb,
                         torch.Generator(device=dev), scal)
    model.eval()
    nv, nq = 60, 150
    vmask = (np.arange(16)[None] < rng.randint(3, 17, nv)[:, None]
             ).astype(np.float32)
    videos = PackedVideos(
        feats=(rng.randn(nv, 16, 48) * vmask[..., None]).astype(np.float32),
        mask=vmask, ids=[f"v{i}" for i in range(nv)])
    q_vid = [f"v{i % nv}" for i in range(nq)]
    queries = PackedQueries(
        feats=rng.randn(nq, 8, 32).astype(np.float32),
        mask=np.ones((nq, 8), np.float32),
        cap_ids=[f"{v}#enc#{i}" for i, v in enumerate(q_vid)],
        video_ids=q_vid)
    gt = torch.from_numpy(build_gt_indices(q_vid, videos.ids)).to(dev)
    fused = []
    scores = []
    for plain in (False, True):
        s = evaluate.score_matrices(model, videos, queries, 16, 50, dev,
                                    plain=plain)
        scores.append(s)
        fused.append(evaluate._metrics_from_score_matrices(
            *s, gt, (0.7, 0.3))["fused"]["sumr"])
    for a, b in zip(scores[0], scores[1]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
    assert fused[0] == fused[1]


# ------------------------------------------------------------ streaming

def _stream_fixture(rng, nv=70, nq=90):
    from dldkd_tpu_torch.data.ingest import PackedQueries

    cfg = ModelConfig(visual_input_size=48, query_input_size=32,
                      inheritance_hidden=64, exploration_hidden=64,
                      max_ctx_l=16, max_desc_l=8, n_heads=4,
                      double_branch=True)
    model = DLDKD(cfg).init_weights(torch.Generator().manual_seed(9)).eval()
    vmask = (np.arange(16)[None] < rng.randint(3, 17, nv)[:, None]
             ).astype(np.float32)
    videos = PackedVideos(
        feats=(rng.randn(nv, 16, 48) * vmask[..., None]).astype(np.float32),
        mask=vmask, ids=[f"v{i}" for i in range(nv)])
    q_vid = [f"v{i % nv}" for i in range(nq)]
    queries = PackedQueries(
        feats=rng.randn(nq, 8, 32).astype(np.float32),
        mask=np.ones((nq, 8), np.float32),
        cap_ids=[f"{v}#enc#{i}" for i, v in enumerate(q_vid)],
        video_ids=q_vid)
    return model, videos, queries


@pytest.mark.parametrize("score_quant", [False, True], ids=["f32", "int8"])
def test_streaming_eval_on_card_matches_resident(dev, score_quant):
    """The streaming engine on the card (double-buffered copies on a side
    stream, all queries per scorer launch) against the resident engine on
    the card: in f32 the same scores bitwise (each row of a tower and each
    (query, video) score is computed alike at any batch), for blocks that
    divide the corpus, that do not, and one larger than it."""
    from dldkd_tpu_torch import evaluate
    from dldkd_tpu_torch.config import EvalConfig

    model, videos, queries = _stream_fixture(np.random.RandomState(10))
    nv = len(videos)
    r_i, r_e = evaluate.score_matrices(model, videos, queries, 16, 50, dev,
                                       score_quant=score_quant)
    for block in (7, 35, 128):
        s_i, s_e = evaluate.stream_score_matrices(
            model, videos, queries, block, 64, dev, score_quant=score_quant)
        assert torch.equal(s_i, r_i[:, :nv]) and torch.equal(s_e,
                                                             r_e[:, :nv])
    cfg = EvalConfig(eval_query_bsz=64, score_quant=score_quant,
                     corpus_stream_bsz=35)
    got = evaluate.run_retrieval_eval(model, videos, queries, cfg,
                                      device=dev)
    assert got == _metrics(evaluate, (r_i, r_e), videos, queries, dev)


def test_resident_query_blocks_on_card_near_50_query_batches(dev):
    """At TVR's widths (frames 3,072 wide, query tokens 768, hidden 384 x
    2, 128 frames, 30 tokens, f32), 300 videos and 1,100 queries: the
    resident engine at RESIDENT_QUERY_BSZ queries a launch (one query-tower
    launch and one scorer launch per branch for each block, the last
    trimmed) against 50 a launch. The f32 query tower's output depends on
    its launch's row count in the last bits, so the scores of each branch
    and of the fusion stay within 1e-6, and every (query, video) pair that
    changes sides of the ground truth's score is a near-tie: at 50 a
    launch its gap is under 1e-6."""
    from dldkd_tpu_torch import evaluate
    from dldkd_tpu_torch.data.ingest import PackedQueries

    nv, nq, block = 300, 1100, evaluate.RESIDENT_QUERY_BSZ
    cfg = ModelConfig(visual_input_size=3072, query_input_size=768,
                      inheritance_hidden=384, exploration_hidden=384,
                      max_ctx_l=128, max_desc_l=30, n_heads=4,
                      double_branch=True)
    model = DLDKD(cfg).init_weights(torch.Generator().manual_seed(24)
                                    ).to(dev).eval()
    rng = np.random.RandomState(24)
    vmask = (np.arange(128)[None] < rng.randint(32, 129, nv)[:, None]
             ).astype(np.float32)
    qmask = (np.arange(30)[None] < rng.randint(8, 31, nq)[:, None]
             ).astype(np.float32)
    gen = torch.Generator().manual_seed(25)
    ids = [f"v{i}" for i in range(nv)]
    q_vid = [ids[i % nv] for i in range(nq)]
    videos = PackedVideos(feats=torch.rand((nv, 128, 3072),
                                           generator=gen).numpy(),
                          mask=vmask, ids=ids)
    queries = PackedQueries(
        feats=torch.randn((nq, 30, 768), generator=gen).numpy(),
        mask=qmask, cap_ids=[f"{v}#enc#{i}" for i, v in enumerate(q_vid)],
        video_ids=q_vid)
    before = dict(qt.LAUNCHES), dict(sim_max.LAUNCHES)
    wide = evaluate.score_matrices(model, videos, queries, 200, block, dev)
    blocks = -(-nq // block)
    assert qt.LAUNCHES["query_tower"] - before[0]["query_tower"] == blocks
    assert sim_max.LAUNCHES["sim_max_f32"] \
        - before[1]["sim_max_f32"] == 2 * blocks
    narrow = evaluate.score_matrices(model, videos, queries, 200, 50, dev)
    gt = torch.arange(nq, device=dev) % nv
    rows = torch.arange(nq, device=dev)
    pairs = list(zip(wide, narrow)) + [(0.7 * wide[0] + 0.3 * wide[1],
                                        0.7 * narrow[0] + 0.3 * narrow[1])]
    for w, n in pairs:
        w, n = w[:, :nv], n[:, :nv]
        assert w.shape == (nq, nv)
        assert (w - n).abs().max().item() <= 1e-6
        gap = n - n[rows, gt][:, None]
        flips = (w > w[rows, gt][:, None]) != (gap > 0)
        assert (gap[flips].abs() < 1e-6).all()


# ------------------------------------------------------------ staging

def _blocking_staging(arrays, block, device, pad=False):
    """The resident engine's staging before the pinned path, as
    `evaluate._blocks_on_device` is called: each block from numpy,
    zero-padded with `pad`, copied by a blocking `.to`."""
    for start in range(0, arrays[0].shape[0], block):
        staged = []
        for a in arrays:
            t = torch.from_numpy(np.ascontiguousarray(a[start:start + block]))
            if pad and t.shape[0] < block:
                t = torch.cat([t, t.new_zeros(
                    (block - t.shape[0],) + tuple(t.shape[1:]))])
            staged.append(t.to(device))
        yield start, staged


def _metrics(evaluate, scores, videos, queries, dev):
    """The eval's metric tail (the ground truth's copy, then the ranks) on
    score matrices made at explicit batch sizes."""
    return evaluate._metrics_from_score_matrices(
        *scores, evaluate._gt_on_device(queries, videos, dev), (0.7, 0.3))


def _resident_eval(evaluate, model, videos, queries, dev, staging=None):
    """One resident eval (16 videos, 20 queries a batch): the frames and
    mask `embed_corpus` returned, the pooled query batches, both score
    matrices and the metric dicts. `staging` stands in for
    `_blocks_on_device`."""
    kept = {"embed_corpus": [], "encode_query_best": [],
            "score_all_queries": []}
    with pytest.MonkeyPatch.context() as mp:
        if staging is not None:
            mp.setattr(evaluate, "_blocks_on_device", staging)
        for name, got in kept.items():
            def keep(*args, real=getattr(evaluate, name), got=got, **kw):
                out = real(*args, **kw)
                got.append(out)
                return out
            mp.setattr(evaluate, name, keep)
        metrics = _metrics(evaluate, evaluate.score_matrices(
            model, videos, queries, 16, 20, dev), videos, queries, dev)
    return kept, metrics


def _assert_same_tensors(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same_tensors(g, w)
    elif want is None:
        assert got is None
    else:
        assert got.shape == want.shape and torch.equal(got, want)


def _stage_workers():
    return [t for t in threading.enumerate()
            if t.name == "eval-stage" and t.is_alive()]


def test_resident_eval_staged_on_card_matches_blocking_copies(dev, tmp_path):
    """The resident engine through the pinned slots and their worker
    (70 videos in 5 context batches, the last padded, so padded rows
    follow real rows; 90 queries in 5 query batches, the last trimmed to
    10) against the
    same batches staged by blocking pageable copies: frames, padded rows
    included, and mask, pooled queries, both score matrices and the
    metric dicts bitwise. Under a profiler every byte but the ground
    truth's goes through a pinned slot, each hand-over of a slot (an
    eval/h2d span) follows one fill on the worker's thread (an eval/stage
    span), and the worker is gone. Slot reuse: the test below."""
    import json

    from dldkd_tpu_torch import evaluate
    from dldkd_tpu_torch.utils import tracing

    model, videos, queries = _stream_fixture(np.random.RandomState(13))
    model = model.to(dev)
    want, want_metrics = _resident_eval(evaluate, model, videos, queries,
                                        dev, _blocking_staging)
    got, metrics = _resident_eval(evaluate, model, videos, queries, dev)
    for name in want:
        _assert_same_tensors(got[name], want[name])
    assert len(got["encode_query_best"]) == 5
    assert metrics == want_metrics

    prof = tracing.start_profile(dev)
    traced, traced_metrics = _resident_eval(evaluate, model, videos,
                                            queries, dev)
    torch.cuda.synchronize()
    path = tracing.stop_profile(prof, str(tmp_path))
    totals = tracing.counts()
    assert traced_metrics == want_metrics
    _assert_same_tensors(traced["score_all_queries"],
                         want["score_all_queries"])
    gt_bytes = 4 * len(queries)
    assert totals["eval.h2d_pinned_bytes"] == totals["eval.h2d_bytes"] \
        - gt_bytes == 4 * (80 * 16 * (48 + 1) + 90 * 8 * (32 + 1))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation"]
    stage = [e for e in events if e["name"] == "eval/stage"]
    h2d = [e for e in events if e["name"] == "eval/h2d"]
    assert len(stage) >= 2 and len(h2d) == len(stage) + 1   # + the gt
    assert {e["tid"] for e in stage}.isdisjoint({e["tid"] for e in h2d})
    assert not _stage_workers()


class _FailingRows(np.ndarray):
    """An array whose rows from 40 on cannot be read: the worker's fill
    of the slot that holds them raises."""

    def __getitem__(self, idx):
        if isinstance(idx, slice) and (idx.stop is None or idx.stop > 40):
            raise ValueError("rows from 40 are unreadable")
        return super().__getitem__(idx)


@pytest.mark.parametrize("where", ["corpus", "queries", "worker"])
def test_staging_stops_when_the_eval_raises(dev, where):
    """A consumer of the staged batches that raises mid-iteration (the
    video or the query tower on its second batch), or a fill that raises
    on the worker (surfaced on the main thread): the error reaches the
    caller, the worker thread is joined within 10 s, and the next eval in
    the process reads the same metrics as before."""
    from dldkd_tpu_torch import evaluate

    model, videos, queries = _stream_fixture(np.random.RandomState(14))
    model = model.to(dev)

    def run(v=videos):
        return _metrics(evaluate, evaluate.score_matrices(
            model, v, queries, 16, 20, dev), v, queries, dev)

    want = run()
    with pytest.MonkeyPatch.context() as mp:
        if where == "worker":
            bad = PackedVideos(videos.feats.view(_FailingRows), videos.mask,
                               videos.ids)
            with pytest.raises(ValueError, match="unreadable"):
                run(bad)
        else:
            name = ("encode_context_best" if where == "corpus"
                    else "encode_query_best")
            real, calls = getattr(evaluate, name), []

            def failing(*args, **kw):
                calls.append(1)
                if len(calls) == 2:
                    raise RuntimeError("consumer fails")
                return real(*args, **kw)

            mp.setattr(evaluate, name, failing)
            with pytest.raises(RuntimeError, match="consumer fails"):
                run()
    deadline = time.monotonic() + 10.0
    while _stage_workers() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not _stage_workers()
    assert run() == want


@pytest.mark.parametrize("pad", [True, False], ids=["padded", "trimmed"])
@pytest.mark.parametrize("row_kb", [128, 1024], ids=["one_slot",
                                                     "7_slot_fills"])
def test_staged_blocks_survive_slow_consumers(dev, pad, row_kb):
    """Every block through the two pinned slots arrives whole and in
    order while the consumer holds the card back (a spin kernel before it
    reads each block) and the interpreter switches threads every
    microsecond: a block's device buffer is not refilled before the
    kernels that read it ran, and a pinned slot not before its copy
    ended. 61 blocks of 3 rows, the last of 1; rows of 128 KB put every
    block in one slot fill, rows of 1 MB ten blocks in a fill (32 MB), so
    the two slots are filled 7 times, the last with one block."""
    import sys

    from dldkd_tpu_torch import evaluate

    rng = np.random.RandomState(15)
    feats = rng.randn(181, row_kb, 256).astype(np.float32)
    mask = (rng.rand(181, 4) > 0.5).astype(np.float32)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        copies = []
        for start, (f, m) in evaluate._blocks_on_device((feats, mask), 3,
                                                        dev, pad=pad):
            torch.cuda._sleep(1_000_000)
            copies.append((start, f.clone(), m.clone()))
        torch.cuda.synchronize()
    finally:
        sys.setswitchinterval(interval)
    assert [c[0] for c in copies] == list(range(0, 181, 3))
    for start, f, m in copies:
        rows = min(3, 181 - start)
        assert f.shape[0] == m.shape[0] == (3 if pad else rows)
        assert torch.equal(f[:rows].cpu(),
                           torch.from_numpy(feats[start:start + rows]))
        assert torch.equal(m[:rows].cpu(),
                           torch.from_numpy(mask[start:start + rows]))
        assert not f[rows:].any() and not m[rows:].any()
    assert not _stage_workers()


def test_staged_copy_waits_for_work_queued_on_recycled_memory(dev):
    """The staging's device buffer comes from the caching allocator on the
    compute stream, which hands out memory whose last kernels are still
    queued there. A buffer of a slot's size is written by a fill queued
    behind a spin kernel and freed before the staging starts, so the slot
    gets its memory: the side stream's copy may not land before the
    queued fill (which would leave the fill's 7s where the block's rows
    belong, as the TVR eval's video towers lost their last batch's buffers
    to the first query copy). Three rounds: the first allocates the pinned
    slot, which can hold the host until the card is idle; the later ones
    reuse it."""
    from dldkd_tpu_torch import evaluate

    feats = np.random.RandomState(22).rand(4, 1024, 2048).astype(np.float32)
    for _ in range(3):
        blocks = []   # nothing freed between the buffer's free and the slot
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        busy = torch.empty(feats.shape, device=dev)
        torch.cuda._sleep(50_000_000)
        busy.fill_(7.0)
        seen = torch.stack([busy.min(), busy.max()])
        freed = busy.data_ptr()
        del busy
        for start, (f,) in evaluate._blocks_on_device((feats,), 4, dev,
                                                      pad=True):
            assert f.data_ptr() == freed   # the freed memory, handed over
            blocks.append(f.clone())
        torch.cuda.synchronize()
        assert seen.tolist() == [7.0, 7.0]
        assert torch.equal(blocks[0].cpu(), torch.from_numpy(feats))
    assert not _stage_workers()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tower_sub_launches_match_one_launch(dev, dtype, monkeypatch):
    """Past `sequences_per_launch` a tower call runs in several launches
    of the chain, each counted: the same outputs bitwise as one launch."""
    gen = torch.Generator().manual_seed(11)
    cfg = ModelConfig(visual_input_size=48, query_input_size=32,
                      inheritance_hidden=64, exploration_hidden=64,
                      max_ctx_l=16, max_desc_l=8, n_heads=4,
                      double_branch=True, dtype=dtype)
    model = DLDKD(cfg).init_weights(torch.Generator().manual_seed(12))
    tdt = getattr(torch, dtype)
    ws = tower_weights(model, dev)["context"]
    x = torch.randn(10, 16, 48, generator=gen).to(dev)
    mask = _mask(10, 16, gen, dev)
    whole = qt.context_towers(x, mask, ws, 4, tdt, "test")
    monkeypatch.setattr(qt, "sequences_per_launch", lambda *a: 3)
    before = qt.LAUNCHES["context_tower"]
    parts = qt.context_towers(x, mask, ws, 4, tdt, "test")
    assert qt.LAUNCHES["context_tower"] - before == 4
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)


# ------------------------------------------- slice 9: artifacts, q8_t

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cap", [None, 50], ids=["one_launch", "sub_launches"])
def test_context_tower_q8_transposed_matches_plain(dev, dtype, cap,
                                                   monkeypatch):
    """The epilogue's transposed write (q8_transposed) bitwise against its
    plain version (the plain epilogue of the same chain's frames on the
    padded rows, permuted), in one launch and across sub-launches (each
    writing its videos at their offset in the one output); the pad bias
    against q8_index_bias's padding."""
    gen = torch.Generator().manual_seed(13)
    cfg = ModelConfig(visual_input_size=48, query_input_size=32,
                      inheritance_hidden=60, exploration_hidden=60,
                      max_ctx_l=20, max_desc_l=8, n_heads=4,
                      double_branch=True, dtype=dtype)
    model = DLDKD(cfg).init_weights(torch.Generator().manual_seed(14))
    tdt = getattr(torch, dtype)
    ws = tower_weights(model, dev)["context"]
    nv, lv = 130, 20                     # pads to 256 videos, 32 frames
    x = torch.randn(nv, lv, 48, generator=gen).to(dev)
    mask = _mask(nv, lv, gen, dev)
    if cap is not None:
        monkeypatch.setattr(qt, "sequences_per_launch", lambda *a: cap)
    before = dict(qt.LAUNCHES)
    got = qt.fused_context_tower_dual(x, mask, *ws, 4, tdt, emit_q8=True,
                                      q8_transposed=True)
    torch.cuda.synchronize()
    n_launch = 1 if cap is None else -(-256 // cap)
    assert qt.LAUNCHES["context_tower_q8_t"] \
        == before["context_tower_q8_t"] + n_launch
    assert qt.LAUNCHES["context_tower_q8"] == before["context_tower_q8"]
    l_p, nv_p = 32, 256
    xp = torch.nn.functional.pad(x, (0, 0, 0, l_p - lv, 0, nv_p - nv))
    mp = torch.nn.functional.pad(mask, (0, l_p - lv, 0, nv_p - nv))
    frames = qt._run(xp, mp, ws, 4, tdt, "context", lv, plain=False)
    for g, f in zip(got, frames):
        assert g.dtype == torch.int8 and tuple(g.shape) == (l_p, nv_p, 60)
        want = qt.q8_transposed_plain(qt.quantize_frames_q8_plain(f))
        assert torch.equal(g, want)
    bias = sim_max.q8_index_bias(mask, l_p, nv_p)
    assert tuple(bias.shape) == (l_p, nv_p)
    assert bool((bias[lv:] == sim_max.INT8_MASK_BIAS).all())
    assert bool((bias[:, nv:] == sim_max.INT8_MASK_BIAS).all())


@pytest.mark.parametrize("kw", [
    dict(), dict(score_quant=True), dict(score_quant=True, rescore=False),
    dict(index_store="raw", stream_block=16)],
    ids=["exact", "two_stage", "int8", "raw"])
def test_index_artifact_round_trip_on_card(dev, kw, tmp_path, monkeypatch):
    """save_index then load_index in a new Retriever on the card: the same
    arrays (real rows) and bitwise the same ids and scores."""
    monkeypatch.setenv("DLDKD_DENSE_RESCORE", "always")
    cfg = ModelConfig(visual_input_size=48, query_input_size=32,
                      inheritance_hidden=64, exploration_hidden=64,
                      max_ctx_l=16, max_desc_l=8, n_heads=4,
                      double_branch=True, dtype="bfloat16")
    model = DLDKD(cfg).init_weights(torch.Generator().manual_seed(15))
    rng = np.random.RandomState(16)
    mask = (np.arange(16)[None] < rng.randint(3, 17, 40)[:, None]
            ).astype(np.float32)
    videos = PackedVideos(feats=rng.randn(40, 16, 48).astype(np.float32),
                          mask=mask, ids=[f"v{i}" for i in range(40)])
    qf = rng.randn(30, 8, 32).astype(np.float32)
    qm = np.ones((30, 8), np.float32)
    r1 = serving.Retriever(model, query_bsz=16, device="cuda", **kw)
    r1.index(videos, context_bsz=16)
    want = r1.search(qf, qm, k=7)
    r1.save_index(str(tmp_path / "idx"))
    r2 = serving.Retriever(model, query_bsz=16, device="cuda", **kw)
    r2.load_index(str(tmp_path / "idx"), context_bsz=16)
    for name in ("ctx_inher", "ctx_explore", "q8_inher", "q8_explore",
                 "raw_feats"):
        a, b = getattr(r1, name), getattr(r2, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.shape == b.shape and torch.equal(a[:40], b[:40]), name
    got = r2.search(qf, qm, k=7)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("h,w", [(240, 320), (100, 150), (500, 333)])
def test_clip_preprocess_on_card_bitwise_cpu(dev, h, w):
    """The teacher's frame preprocessing (PIL's bicubic as two float64
    products of integers, exact; then float32 rescale and normalize) on
    the card: bitwise the CPU's."""
    from dldkd_tpu_torch.tools.clip_preprocess import (ClipPreprocessor,
                                                       PreprocessConfig)

    frames = np.random.RandomState(h).randint(0, 256, (6, h, w, 3),
                                              dtype=np.uint8)
    cfg = PreprocessConfig()
    got = ClipPreprocessor(cfg, dev)(frames)
    assert got.device.type == "cuda" and got.shape == (6, 3, 224, 224)
    assert torch.equal(got.cpu(), ClipPreprocessor(cfg, "cpu")(frames))


def test_clip_forward_on_card_matches_cpu(dev):
    """A two-layer CLIP at ViT-B/32's head widths (64), text and image
    features on the card against the CPU: within 1e-4 abs (f32 products
    at "highest" on both, sums in another order)."""
    from dldkd_tpu_torch.models.clip import (ClipConfig, ClipModel,
                                             ClipTowerConfig)

    torch.set_float32_matmul_precision("highest")
    cfg = ClipConfig(
        text=ClipTowerConfig(hidden_size=128, intermediate_size=512,
                             num_hidden_layers=2, num_attention_heads=2,
                             eos_token_id=2),
        vision=ClipTowerConfig(hidden_size=128, intermediate_size=512,
                               num_hidden_layers=2, num_attention_heads=2),
        projection_dim=64)
    cpu = ClipModel(cfg).init_weights(torch.Generator().manual_seed(17))
    card = ClipModel(cfg)
    card.load_state_dict(cpu.state_dict())
    card.to(dev)
    rng = np.random.RandomState(18)
    ids = torch.from_numpy(rng.randint(0, 49406, (8, 77)))
    ids[:, 0], ids[:, 20] = 49406, 49407
    mask = (torch.arange(77)[None] <= 20).int().expand(8, 77)
    px = torch.from_numpy(rng.randn(4, 3, 224, 224).astype(np.float32))
    with torch.no_grad():
        pairs = ((cpu.get_text_features(ids, mask),
                  card.get_text_features(ids.to(dev), mask.to(dev))),
                 (cpu.get_image_features(px),
                  card.get_image_features(px.to(dev))))
    for want, got in pairs:
        assert float(want.abs().max()) > 0.01
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_branch_launch_moves_the_1br_counters(dev, dtype):
    """A single-branch model's tower launch (the one-branch Pallas kernels'
    counterpart) moves query_tower_1br / context_tower_1br by one each;
    the two-branch model's launch moves neither."""
    from dldkd_tpu_torch.ops.fast_eval import (encode_context_best,
                                               encode_query_best)

    cfg = ModelConfig(visual_input_size=40, query_input_size=24,
                      inheritance_hidden=32, exploration_hidden=32,
                      max_ctx_l=12, max_desc_l=8, n_heads=4,
                      double_branch=True, dtype=dtype)
    dual = DLDKD(cfg).init_weights(torch.Generator().manual_seed(21))
    one = DLDKD(cfg.replace(double_branch=False))
    one.load_state_dict({k: v for k, v in dual.state_dict().items()
                         if k in one.state_dict()}, strict=True)
    gen = torch.Generator().manual_seed(22)
    vf = torch.randn(6, 12, 40, generator=gen).to(dev)
    qf = torch.randn(5, 8, 24, generator=gen).to(dev)
    vm, qm = _mask(6, 12, gen, dev), _mask(5, 8, gen, dev)
    names = ("query_tower_1br", "context_tower_1br")
    for model, moved in ((dual.to(dev).eval(), 0), (one.to(dev).eval(), 1)):
        before = {n: qt.LAUNCHES[n] for n in names}
        towers = (qt.LAUNCHES["query_tower"], qt.LAUNCHES["context_tower"])
        ci = encode_context_best(model, vf, vm)
        qi = encode_query_best(model, qf, qm)
        torch.cuda.synchronize()
        assert (ci[1] is None) == (qi[1] is None) == bool(moved)
        assert (qt.LAUNCHES["query_tower"], qt.LAUNCHES["context_tower"]) \
            == (towers[0] + 1, towers[1] + 1)
        assert {n: qt.LAUNCHES[n] - before[n] for n in names} \
            == {n: moved for n in names}


@pytest.mark.parametrize("score_quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("block", [0, 35], ids=["resident", "streaming"])
def test_sharded_eval_on_card_matches_single_device(dev, score_quant,
                                                    block):
    """The corpus-sharded eval on a mesh of two shards on one card
    (parallel/eval_shard.py) against the single-device resident engine:
    the same scores bitwise (each tower row and each (query, video) score
    is computed alike at any batch, as for streaming above) and the same
    metrics, through run_retrieval_eval."""
    import dataclasses

    from dldkd_tpu_torch import evaluate
    from dldkd_tpu_torch.config import EvalConfig
    from dldkd_tpu_torch.parallel import eval_shard, make_mesh

    model, videos, queries = _stream_fixture(np.random.RandomState(12))
    nv = len(videos)
    mesh = make_mesh(devices=[dev, dev])
    r_i, r_e = evaluate.score_matrices(model, videos, queries, 16, 50, dev,
                                       score_quant=score_quant)
    s_i, s_e = eval_shard.sharded_score_matrices(
        model, videos, queries, mesh, query_bsz=64, score_quant=score_quant,
        corpus_block=block)
    assert torch.equal(s_i, r_i[:, :nv]) and torch.equal(s_e, r_e[:, :nv])
    cfg = EvalConfig(eval_query_bsz=50, eval_context_bsz=16,
                     score_quant=score_quant,
                     corpus_stream_bsz=block or -1)
    assert evaluate.run_retrieval_eval(model, videos, queries, cfg,
                                       mesh=mesh) == \
        evaluate.run_retrieval_eval(
            model, videos, queries,
            dataclasses.replace(cfg, corpus_stream_bsz=-1), device=dev)


@pytest.mark.parametrize("kw", [
    dict(), dict(score_quant=True), dict(score_quant=True, rescore=False),
    dict(index_store="raw"), dict(index_store="raw", score_quant=True),
    dict(index_store="raw", score_quant=True, rescore=False)],
    ids=["exact", "two_stage", "int8", "raw_exact", "raw_two_stage",
         "raw_int8"])
def test_sharded_serving_on_card_matches_single_device(dev, kw,
                                                       monkeypatch):
    """A mesh of two shards on the card against the single-device
    Retriever on each route (stage 2 pinned to the dense kernel): ids
    equal, scores within 1e-5."""
    from dldkd_tpu_torch.parallel import make_mesh

    monkeypatch.setenv("DLDKD_DENSE_RESCORE", "always")
    cfg = ModelConfig(visual_input_size=48, query_input_size=32,
                      inheritance_hidden=64, exploration_hidden=64,
                      max_ctx_l=16, max_desc_l=8, n_heads=4,
                      double_branch=True, dtype="bfloat16")
    model = DLDKD(cfg).init_weights(torch.Generator().manual_seed(17))
    rng = np.random.RandomState(18)
    mask = (np.arange(16)[None] < rng.randint(3, 17, 45)[:, None]
            ).astype(np.float32)
    videos = PackedVideos(feats=rng.randn(45, 16, 48).astype(np.float32),
                          mask=mask, ids=[f"v{i}" for i in range(45)])
    qf = rng.randn(30, 8, 32).astype(np.float32)
    qm = np.ones((30, 8), np.float32)
    kw = dict(kw, query_bsz=16, stream_block=8)
    single = serving.Retriever(model, device="cuda", **kw)
    single.index(videos, context_bsz=16)
    want = single.search(qf, qm, k=7)
    r = serving.Retriever(model, device="cuda", **kw,
                          mesh=make_mesh(devices=[dev, dev]))
    r.index(videos, context_bsz=16)
    got = r.search(qf, qm, k=7)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)


# ------------------------------------------------------------ tracing

def test_kernel_spans_hold_their_launches_on_card(dev, tmp_path):
    """A resident eval under torch.profiler on the card: every kernel
    launched inside a kernels/* span starts after the span does, a video
    tower call runs its chain's 6 kernels and a scorer call 1, and Kineto
    draws each kernels/* span on the device row (gpu_user_annotation), the
    hook that attributes device time to the program's spans."""
    import json

    from dldkd_tpu_torch import evaluate
    from dldkd_tpu_torch.config import EvalConfig
    from dldkd_tpu_torch.data.ingest import PackedQueries
    from dldkd_tpu_torch.utils import tracing

    cfg = ModelConfig(visual_input_size=64, query_input_size=48,
                      inheritance_hidden=32, exploration_hidden=32,
                      max_ctx_l=16, max_desc_l=12, n_heads=4,
                      double_branch=True)
    model = DLDKD(cfg).init_weights(torch.Generator().manual_seed(5)
                                    ).to(dev).eval()
    rng = np.random.RandomState(6)
    mask = (np.arange(16)[None] < rng.randint(3, 17, 40)[:, None]
            ).astype(np.float32)
    ids = [f"v{i}" for i in range(40)]
    gt = [ids[i % 40] for i in range(30)]
    videos = PackedVideos(feats=rng.randn(40, 16, 64).astype(np.float32),
                          mask=mask, ids=ids)
    queries = PackedQueries(feats=rng.randn(30, 12, 48).astype(np.float32),
                            mask=np.ones((30, 12), np.float32),
                            cap_ids=[f"{v}#{i}" for i, v in enumerate(gt)],
                            video_ids=gt)
    eval_cfg = EvalConfig(eval_query_bsz=10, eval_context_bsz=16,
                          corpus_stream_bsz=-1)
    evaluate.run_retrieval_eval(model, videos, queries, eval_cfg, device=dev)
    prof = tracing.start_profile(dev)
    evaluate.run_retrieval_eval(model, videos, queries, eval_cfg, device=dev)
    torch.cuda.synchronize()
    with open(tracing.stop_profile(prof, str(tmp_path))) as f:
        events = json.load(f)["traceEvents"]

    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith("kernels/"))
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    per_span = {s: 0 for s in spans}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        at = launched[e["args"]["correlation"]]
        holder = [s for s in spans if s[0] <= at <= s[1]]
        if holder:
            assert holder[0][0] < float(e["ts"]), holder[0]
            per_span[holder[0]] += 1
    by_name = {}
    for s, n in per_span.items():
        by_name.setdefault(s[2], []).append(n)
    # 30 queries in blocks of run_retrieval_eval's floor under 10: one
    blocks = -(-30 // max(10, evaluate.RESIDENT_QUERY_BSZ))
    assert by_name["kernels/context_tower"] == [6] * 3   # 40 videos, 16 a batch
    assert by_name["kernels/sim_max"] == [1] * (2 * blocks)   # x 2 branches
    assert len(by_name["kernels/query_tower"]) == blocks
    assert min(by_name["kernels/query_tower"]) >= 5      # the chain's 5
    drawn = [e["name"] for e in events
             if e.get("cat") == "gpu_user_annotation"]
    for name, n in (("kernels/context_tower", 3),
                    ("kernels/query_tower", blocks),
                    ("kernels/sim_max", 2 * blocks)):
        assert drawn.count(name) == n, name
