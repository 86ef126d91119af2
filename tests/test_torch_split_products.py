"""The split products of the tensor-core scorers, on the CPU.

f32 scoring (`sim_max_f32`) multiplies in 3xTF32 and exact rescoring
(`sim_max_exact`) in three bf16 products of a split f32 query
(csrc/sim_max_mma.cu). The kernels run only on the card; here the splits
(`ops/kernels/sim_max.py:split_tf32`, `split_bf16x3`) are held to their
definitions, and a torch emulation of each kernel's arithmetic (f32
matmuls of the split parts, whose products are exact in f32, summed, then
masked or scaled, then the max) to the plain versions and to the Pallas
kernels in interpret mode.

Tolerances: the splits bitwise (the JAX kernel's own formula, integer
rounding rules); the emulated f32 scorer within 1e-5 of the plain version
and of `fused_clip_scores` at "highest" precision (each product within
2^-22 of the f32 one, f32 sums in another order), the emulated exact
scorer within 5e-6 of the plain version and of `fused_exact_scores` (exact
products, f32 sums in another order, the Pallas kernel's scale after the
dot) — the card tolerances of tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dldkd_tpu.ops import similarity as jax_sim
from dldkd_tpu.ops.pallas import sim_max as jax_sm
from dldkd_tpu_torch.ops.kernels import sim_max
from dldkd_tpu_torch.ops.masking import l2_normalize, mask_logits

F32_TOL = 1e-5
EXACT_TOL = 5e-6


@pytest.fixture(autouse=True, scope="module")
def _torch_numerics():
    threads = torch.get_num_threads()
    precision = torch.get_float32_matmul_precision()
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(threads)
    torch.set_float32_matmul_precision(precision)


def _inputs(nq, nv, l_frames, d, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(nq, d).astype(np.float32)
    ctx = rng.randn(nv, l_frames, d).astype(np.float32)
    mask = (rng.rand(nv, l_frames) < 0.7).astype(np.float32)
    mask[:, 0] = 1.0
    mask[min(2, nv - 1)] = 0.0       # an all-masked (padding) video
    return q, ctx, mask


def _bits(a, dtype):
    return np.asarray(a).view(dtype)


# ---------------------------------------------------------------- splits

@pytest.mark.parametrize("scale", [1.0, 0.05, 3e4])
def test_bf16x3_split_matches_the_pallas_kernels_formula(scale):
    rng = np.random.RandomState(1)
    q = (rng.randn(7, 53) * scale).astype(np.float32)
    q[0, :4] = [1.0, -0.0, 1.0 + 2.0 ** -8, -(1.0 + 3 * 2.0 ** -9)]
    qj = jnp.asarray(q)
    # dldkd_tpu/ops/pallas/sim_max.py:85-88
    q1 = qj.astype(jnp.bfloat16)
    r = qj - q1.astype(jnp.float32)
    q2 = r.astype(jnp.bfloat16)
    q3 = (r - q2.astype(jnp.float32)).astype(jnp.bfloat16)
    got = sim_max.split_bf16x3(torch.from_numpy(q))
    for g, w in zip(got, (q1, q2, q3)):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                      _bits(w, np.int16))
    total = sum(p.double() for p in got)
    np.testing.assert_array_equal(total.numpy(), q.astype(np.float64))


def _rna_tf32(x: np.ndarray) -> np.ndarray:
    """x rounded to 11 significant bits, to nearest with ties away from
    zero, by float arithmetic in f64: the reference for the bit trick."""
    x = x.astype(np.float64)
    out = np.zeros_like(x)
    nz = x != 0
    ulp = 2.0 ** (np.floor(np.log2(np.abs(x[nz]))) - 10)
    out[nz] = np.sign(x[nz]) * np.floor(np.abs(x[nz]) / ulp + 0.5) * ulp
    return out.astype(np.float32)


def test_tf32_split_rounds_like_cvt_rna():
    patterns = np.array([
        0x3F800000,               # 1.0: already TF32
        0x3F801000,               # 1 + half an ulp: a tie, away from zero
        0x3F803000,               # 1 + 1.5 ulps: a tie, away from zero
        0x3F800FFF,               # just below half: down
        0x3F801001,               # just above half: up
        0xBF801000,               # -(1 + half an ulp): away from zero
        0xBF800FFF,               # negative, below half
        0x3FFFF000,               # the carry into the exponent: 2.0
        0xBFFFFFFF,               # negative carry: -2.0
        0x00000000, 0x80000000,   # +0, -0
        0x3D4CCCCD,               # 0.05
        0x00801000,               # the smallest normal exponent, a tie
        0x7F7FE000,               # the largest TF32-exact normal
    ], dtype=np.uint32)
    x = patterns.view(np.float32)
    big, small = sim_max.split_tf32(torch.from_numpy(x.copy()))
    big_bits = big.numpy().view(np.uint32)
    assert not np.any(big_bits & 0x1FFF)
    np.testing.assert_array_equal(big.numpy(), _rna_tf32(x))
    np.testing.assert_array_equal((big + small).numpy(), x)
    want_big = {0x3F801000: 0x3F802000, 0x3F803000: 0x3F804000,
                0x3F800FFF: 0x3F800000, 0xBF801000: 0xBF802000,
                0x3FFFF000: 0x40000000, 0xBFFFFFFF: 0xC0000000}
    for p, b in want_big.items():
        assert big_bits[list(patterns).index(p)] == b


def test_tf32_split_is_exact_on_random_values():
    rng = np.random.RandomState(2)
    x = (rng.randn(4000) * np.exp(rng.randn(4000) * 5)).astype(np.float32)
    big, small = sim_max.split_tf32(torch.from_numpy(x))
    assert not np.any(big.numpy().view(np.uint32) & 0x1FFF)
    np.testing.assert_array_equal(big.numpy(), _rna_tf32(x))
    np.testing.assert_array_equal((big + small).numpy(), x)
    # small is at most half a TF32 ulp of x
    assert np.all(np.abs(small.numpy()) <= np.abs(x) * 2.0 ** -11)


# ---------------------------------------------------- the kernels' arithmetic

def _tf32_read(x):
    """What a tensor core reads of an f32 value: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def emulate_f32_scorer(qn, cn, mask):
    """sim_max_f32's arithmetic: big.big + big.small + small.big, each an
    f32 matmul of TF32 values (exact products), small as the tensor core
    reads it; then the mask and the frame max."""
    nv, l_frames, d = cn.shape
    qb, qs = sim_max.split_tf32(qn)
    cb, cs = sim_max.split_tf32(cn.reshape(nv * l_frames, d))
    s = qb @ _tf32_read(cs).T + _tf32_read(qs) @ cb.T + qb @ cb.T
    s = s.reshape(-1, nv, l_frames)
    return mask_logits(s, mask[None]).amax(dim=-1)


def emulate_exact_scorer(qn, ctx, inv, bias):
    """sim_max_exact's arithmetic: three bf16 parts of the query times the
    bf16 frames (exact products), summed in f32; then s * inv + bias and
    the frame max."""
    nv, l_frames, d = ctx.shape
    c2 = ctx.reshape(nv * l_frames, d).float()
    s = sum(p.float() @ c2.T for p in sim_max.split_bf16x3(qn))
    s = s.reshape(-1, nv, l_frames)
    return (s * inv[None] + bias[None]).amax(dim=-1)


@pytest.mark.parametrize("nq,nv,l_frames,d", [(9, 13, 5, 48), (4, 7, 17, 20),
                                              (1, 3, 1, 100)])
def test_f32_split_scorer_matches_plain_and_pallas(nq, nv, l_frames, d):
    q, ctx, mask = _inputs(nq, nv, l_frames, d, seed=nq + d)
    qn, cn = l2_normalize(torch.from_numpy(q)), l2_normalize(
        torch.from_numpy(ctx))
    m = torch.from_numpy(mask)
    got = emulate_f32_scorer(qn, cn, m)
    plain = sim_max.sim_max_plain(qn, cn, m)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=F32_TOL,
                               rtol=0)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_sim.clip_scores_maxpool(
            jnp.asarray(q), jnp.asarray(ctx), jnp.asarray(mask),
            prefer_pallas=True, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=0)
    assert np.all(got.numpy()[:, min(2, nv - 1)] <= -1e9)
    # and the small terms carry weight: TF32 products alone stray further
    qb, cb = sim_max.split_tf32(qn)[0], sim_max.split_tf32(cn)[0]
    big_only = sim_max.sim_max_plain(qb, cb, m)
    assert float((big_only - plain).abs().max()) > \
        4 * float((got - plain).abs().max())


@pytest.mark.parametrize("nq,nv,l_frames,d", [(9, 13, 5, 16), (3, 6, 19, 40)])
def test_exact_split_scorer_matches_plain_and_pallas(nq, nv, l_frames, d):
    q, ctx, mask = _inputs(nq, nv, l_frames, d, seed=3 * nq + d)
    ctx16 = torch.from_numpy(3 * ctx).to(torch.bfloat16)
    m = torch.from_numpy(mask)
    qn = l2_normalize(torch.from_numpy(q))
    inv, bias = sim_max.exact_frame_scales(ctx16, m)
    got = emulate_exact_scorer(qn, ctx16, inv, bias)
    plain = sim_max.sim_max_exact_plain(qn, ctx16, inv, bias)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=EXACT_TOL,
                               rtol=0)
    nq_p, nv_p, l_p = 256, 128, -(-l_frames // 8) * 8
    want = np.asarray(jax_sm.fused_exact_scores(
        jnp.pad(jnp.asarray(q), ((0, nq_p - nq), (0, 0))),
        jnp.pad(jnp.asarray(3 * ctx).astype(jnp.bfloat16),
                ((0, nv_p - nv), (0, l_p - l_frames), (0, 0))),
        jnp.pad(jnp.asarray(mask), ((0, nv_p - nv), (0, l_p - l_frames))),
        q_tile=256, l_tile=8, interpret=True))[:nq, :nv]
    valid = mask.max(axis=1) > 0
    np.testing.assert_allclose(got.numpy()[:, valid], want[:, valid],
                               atol=EXACT_TOL, rtol=0)
    assert np.all(got.numpy()[:, ~valid] <= -1e9)

