"""The towers' fused epilogues on the CPU: the LayerNorms and the query
tower's pooling as the whole-row products of csrc/tower_mma.cu
(`tower_gemm_ln`) compute them, held against the plain version and the
JAX package.

The CUDA kernels run only on the card. Here the chain's emulation
(`tests/test_torch_tower_split.py:emulate_tower`: the products' split or
bf16 arithmetic, the attention's key tiles, the epilogues' rounding points)
takes the fused epilogue's sums in the kernel's orders:
- LayerNorm: lane l of a row's warp adds columns l, l + 32, ... of the
  first H (s += v, ss = fma(v, v, ss)), then a butterfly over the 32 lanes
  (xor 16, 8, 4, 2, 1); mu = s / H, rstd = 1 / sqrt(fma(-mu, mu, ss / H)
  + 1e-5), y = round(fma((x - mu) rstd, gamma, beta));
- pooling: the logit of a row, lane d taking d, d + 32, ... of s = fma(y,
  wm, s), then the butterfly; -1e10 where masked; the sequence's max; e =
  exp(a - max), summed over lanes l, l + 32, ... and the butterfly; p = e /
  sum; pooled = fma(y, p, acc) over the tokens in order.
An f32 fma is emulated in f64 (exact product, one f64 sum) and rounded
once to f32, which may differ from the card's in the last bit.

Tolerances: against `tower_plain` (IEEE f32 products, torch's reductions)
the card's tower tolerances (tests/test_torch_cuda.py): 1e-4 in f32 (five
chained products, sums in another order) and 3e-2 in bf16 (the same
rounding points; another sum order flips a bf16 rounding now and then);
against the Pallas towers in interpret mode those of
tests/test_torch_towers.py and tests/test_torch_tower_split.py: 1e-4 in
f32, 5e-2 abs plus 1.6e-2 rel in bf16 (the Pallas kernel's f32 sums in
another order put an intermediate on the other side of a bf16 rounding
boundary now and then).

Cases: both tower kinds, the two-branch and the one-branch launch, both
dtypes; hidden sizes that are not multiples of 8 (20 and 36: 4 heads of 5
and 9 dims, the branch padded to 24 and 40 columns); query sequences of 24
and 40 tokens, which do not divide a block's 64 rows (two sequences, and
one, in a block), and of 136, longer than one block (its LayerNorm's rows
go through device memory and the block walks three row tiles).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dldkd_tpu.ops import fast_eval as jax_fast
from dldkd_tpu_torch.config import ModelConfig
from dldkd_tpu_torch.models import DLDKD
from dldkd_tpu_torch.ops.kernels import query_tower as qt
from tests.test_torch_tower_split import (TOWER_TOL, _SMALL, _inputs,
                                          _jax_models, _jit, _launch,
                                          emulate_tower)

PALLAS_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (5e-2, 1.6e-2)}


@pytest.fixture(autouse=True, scope="module")
def _torch_numerics():
    threads = torch.get_num_threads()
    precision = torch.get_float32_matmul_precision()
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(threads)
    torch.set_float32_matmul_precision(precision)


# ------------------------------------------- the epilogue's sum orders

def _fma(a, b, c):
    """f32 fma(a, b, c): the product exact in f64, the sum rounded to f64,
    then once to f32."""
    return (a.double() * b.double() + c.double()).float()


def _butterfly(acc):
    """The lanes' values (..., 32) combined xor 16, 8, 4, 2, 1 apart; every
    lane ends with the same value, kept as (..., 1)."""
    width = 32
    while width > 1:
        width //= 2
        acc = acc[..., :width] + acc[..., width:2 * width]
    return acc


def lane_sum(v, w=None):
    """f32 sum over the last axis in a warp's order: lane l takes elements
    l, l + 32, ... in turn (s += v, or s = fma(v, w, s) with w broadcast
    over v), then the butterfly. Keeps the last axis (size 1)."""
    acc = torch.zeros(*v.shape[:-1], 32)
    for k in range(0, v.shape[-1], 32):
        chunk = v[..., k:k + 32]
        pad = 32 - chunk.shape[-1]
        chunk = torch.nn.functional.pad(chunk, (0, pad))
        if w is None:
            acc = acc + chunk
        else:
            acc = _fma(chunk, torch.nn.functional.pad(w[..., k:k + 32],
                                                      (0, pad)), acc)
    return _butterfly(acc)


def ln_lanes(v, gamma, beta, hdim, rt):
    """The fused LayerNorm of rows v (..., Hp) at the true width hdim."""
    t = v[..., :hdim]
    s, ss = lane_sum(t), lane_sum(t, t)
    mu = s / hdim
    var = _fma(-mu, mu, ss / hdim)
    rstd = 1.0 / torch.sqrt(var + 1e-5)
    return rt(_fma((v - mu) * rstd, gamma, beta))


def pool_lanes(out, mask, wm):
    """The fused pooling of (N, L, H) LayerNorm rows with wm (H,)."""
    logits = lane_sum(out, wm).squeeze(-1)
    logits = torch.where(mask > 0, logits, torch.full_like(logits,
                                                           qt.NEG_INF))
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = e / lane_sum(e)
    acc = torch.zeros(out.shape[0], out.shape[2])
    for l in range(out.shape[1]):
        acc = _fma(out[:, l], p[:, l, None], acc)
    return acc


def emulate_fused(x, mask, packed, n_heads, dtype, kind, pos_rows=None):
    """The fused chain: `emulate_tower` with the epilogue's sum orders."""
    return emulate_tower(x, mask, packed, n_heads, dtype, kind, pos_rows,
                         ln=ln_lanes, pool=pool_lanes)


def _emulated_and_plain(model, kind, xa, ma):
    packed, ws, xp, mp, rows, n_heads, dtype = _launch(
        model, kind, torch.from_numpy(xa), torch.from_numpy(ma))
    got = emulate_fused(xp, mp, packed, n_heads, dtype, kind, pos_rows=rows)
    want = qt.tower_packed_plain(xp, mp, packed, n_heads, dtype, kind,
                                 pos_rows=rows)
    return got, want, dtype


def _assert_close(got, want, atol, rtol=0.0):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


# ------------------------------------------------------------- tests

def test_lane_sums_are_f32_sums_in_the_warps_order():
    """The emulated sums: within f32 rounding of f64; the plain sum in the
    order of query_tower._warp_order_sum (the int8 epilogue's, bitwise)."""
    gen = torch.Generator().manual_seed(3)
    v = torch.randn(5, 7, 100, generator=gen)
    w = torch.randn(100, generator=gen)
    assert torch.equal(lane_sum(v), qt._warp_order_sum(v))
    ref = (v.double() * w.double()).sum(-1, keepdim=True)
    assert float((lane_sum(v, w).double() - ref).abs().max()) < 1e-4
    rows = torch.randn(4, 3, 40, generator=gen)
    gamma, beta = torch.randn(40, generator=gen), torch.randn(40,
                                                             generator=gen)
    mask = torch.ones(4, 3)
    mask[0, 1:] = 0.0
    mask[1] = 0.0                    # an all-masked sequence: uniform

    def ident(t):
        return t

    got = ln_lanes(rows, gamma, beta, 40, ident)
    _assert_close(got, qt._ln(rows, gamma, beta, torch.float32).numpy(),
                  1e-5)
    _assert_close(pool_lanes(got, mask, w[:40]),
                  qt.pool_plain(got, mask, w[:40, None],
                                torch.float32).numpy(), 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("double", [True, False], ids=["dual", "single"])
@pytest.mark.parametrize("kind", ["query", "context"])
def test_fused_chain_matches_plain_and_pallas(kind, double, dtype):
    jmodel, params, model = _jax_models(dtype, double=double)
    d = _SMALL["query_input_size" if kind == "query" else "visual_input_size"]
    l = 12 if kind == "query" else 16
    # no all-masked row: test_torch_tower_split.py says why at these weights
    xa, ma = _inputs(9, l, d, seed=3, scale=3.0, all_masked=False)
    got, want, tdt = _emulated_and_plain(model, kind, xa, ma)
    fn = jax_fast.encode_query_best if kind == "query" \
        else jax_fast.encode_context_best
    pallas = _jit(fn, prefer_pallas=True, interpret=True)(
        params, jmodel.config, jnp.asarray(xa), jnp.asarray(ma))
    assert len(got) == (2 if double else 1)
    for g, w, p in zip(got, want, pallas):
        assert g.dtype == w.dtype
        _assert_close(g, w.float().numpy(), TOWER_TOL[tdt])
        _assert_close(g, jnp.asarray(p, jnp.float32), *PALLAS_TOL[tdt])


def _model(dtype, hidden, l, d=40):
    cfg = ModelConfig(visual_input_size=d, query_input_size=d,
                      inheritance_hidden=hidden, exploration_hidden=hidden,
                      max_ctx_l=l, max_desc_l=l, n_heads=4,
                      double_branch=True, dtype=dtype)
    return DLDKD(cfg).init_weights(torch.Generator().manual_seed(6)).eval()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden", [20, 36])
@pytest.mark.parametrize("kind", ["query", "context"])
def test_fused_chain_at_hidden_not_multiple_of_8(kind, hidden, dtype):
    """4 heads of 5 or 9 dims: each branch padded to 24 or 40 columns, the
    LayerNorm's statistics and the pooling over the true width."""
    model = _model(dtype, hidden, 16)
    xa, ma = _inputs(5, 16, 40, seed=hidden)
    got, want, tdt = _emulated_and_plain(model, kind, xa, ma)
    for g, w in zip(got, want):
        assert g.shape[-1] == hidden
        _assert_close(g, w.float().numpy(), TOWER_TOL[tdt])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("l", [24, 40, 136])
def test_fused_pooling_at_sequence_lengths(l, dtype):
    """Query sequences that a block's 64 rows hold twice (24), once with
    rows to spare (40), or only in three row tiles (136: the LayerNorm's
    rows through device memory)."""
    assert qt.pool_rows_spill(40, l) == (l > 64)
    assert qt.pool_rows_spill(8 * 128 + 8, 24)
    model = _model(dtype, 32, l)
    xa, ma = _inputs(3, l, 40, seed=l)
    got, want, tdt = _emulated_and_plain(model, "query", xa, ma)
    for g, w in zip(got, want):
        _assert_close(g, w.numpy(), TOWER_TOL[tdt])
