"""The port's int8 and exact-rescore pieces against the JAX package: the
int8 quantizers, the prebuilt int8 index and its scoring (plain versions
against the Pallas `_sim_max_kernel_int8` in interpret mode), the exact
rescore scorers (against `_sim_max_kernel_exact` in interpret mode and the
XLA paths), the dense-rescore mode knob, and the video towers' int8
epilogue (against `encode_context_q8` through the Pallas towers in
interpret mode).

Tolerances:
- int8 components and int8 scores: bitwise, f32 inputs and valid videos
  (integer arithmetic below 2^24 on both sides);
- int8 components from bf16 inputs: the knife-edge contract of
  tests/test_fast_eval.py (|diff| <= 1 level on a small share: the bf16
  norm sum rounds at another place when its f32 sum sits within an ulp of
  a bf16 boundary);
- exact scores: 2e-6 abs (f32 products against the same stored frames,
  summed in another order; the split-3 kernel scales by a reciprocal norm
  after the dot, ~1 ulp from normalize-then-dot).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dldkd_tpu.config import ModelConfig as JaxModelConfig
from dldkd_tpu.models import DLDKD as JaxDLDKD
from dldkd_tpu.ops import fast_eval as jax_fast_eval
from dldkd_tpu.ops import masking as jax_masking
from dldkd_tpu.ops import similarity as jax_sim
from dldkd_tpu.ops.pallas import query_tower as jax_qt
from dldkd_tpu.ops.pallas import sim_max as jax_sm
from dldkd_tpu.train import init_params
from dldkd_tpu_torch.config import ModelConfig
from dldkd_tpu_torch.convert import load_jax_params
from dldkd_tpu_torch.models import DLDKD
from dldkd_tpu_torch.ops import fast_eval, similarity
from dldkd_tpu_torch.ops.kernels import query_tower as qt
from dldkd_tpu_torch.ops.kernels import sim_max
from dldkd_tpu_torch.ops.masking import l2_normalize
from tests.test_fast_eval import _assert_q8_equal_mod_knife_edge

EXACT_TOL = 2e-6


@pytest.fixture(autouse=True, scope="module")
def _torch_numerics():
    threads = torch.get_num_threads()
    precision = torch.get_float32_matmul_precision()
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(threads)
    torch.set_float32_matmul_precision(precision)


def _t(x, dtype=None):
    t = torch.tensor(np.asarray(x, np.float32))
    return t if dtype is None else t.to(dtype)


def _inputs(nq, nv, l_frames, d, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(nq, d).astype(np.float32)
    ctx = rng.randn(nv, l_frames, d).astype(np.float32)
    mask = (rng.rand(nv, l_frames) < 0.7).astype(np.float32)
    mask[:, 0] = 1.0
    mask[min(3, nv - 1)] = 0.0       # an all-masked (padding) video
    return q, ctx, mask


def _valid(mask):
    return np.asarray(mask).max(axis=1) > 0


# ------------------------------------------------------------- quantizers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_unit_int8_matches_jax(dtype):
    """Half-way points round to even, as jnp.round does; saturation."""
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.uniform(-1.2, 1.2, 500),
                        (np.arange(-127, 127) + 0.5) / 127.0,
                        [1.0, -1.0, 2.0, -3.0, 0.0]]).astype(np.float32)
    want = jax_sm.quantize_unit_int8(jnp.asarray(x).astype(dtype))
    got = qt.quantize_unit_int8(_t(x, getattr(torch, dtype)))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("h", [48, 60, 100, 384, 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_frames_q8_matches_jax(dtype, h):
    """The epilogue's plain version against the canonical
    quantize_frames_q8 and the TPU epilogue's `_quantize_q8`."""
    rng = np.random.RandomState(3)
    x = rng.randn(200, h).astype(np.float32) * 2
    x[0] = 0.0                       # the eps clamp
    xj = jnp.asarray(x).astype(dtype)
    got = qt.quantize_frames_q8(_t(x, getattr(torch, dtype)))
    assert got.dtype == torch.int8 and tuple(got.shape) == x.shape
    for want in (jax_sm.quantize_frames_q8(xj), jax_qt._quantize_q8(xj)):
        if dtype == "float32":
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            _assert_q8_equal_mod_knife_edge(got.numpy(), want)


def test_warp_order_sum_is_a_sum():
    """The epilogue's fixed summation order adds every element once (odd
    widths included), to f32 accuracy."""
    rng = np.random.RandomState(1)
    for h in (1, 7, 32, 45, 384):
        x = torch.from_numpy(rng.rand(5, h).astype(np.float32))
        got = qt._warp_order_sum(x)
        assert tuple(got.shape) == (5, 1)
        np.testing.assert_allclose(got[:, 0].numpy(),
                                   x.double().sum(-1).numpy(), rtol=1e-6)


# ----------------------------------------------------------- int8 scoring

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nq,nv,l_frames,d", [(16, 130, 9, 32),
                                              (7, 37, 5, 24)])
def test_int8_index_scores_match_pallas(nq, nv, l_frames, d, dtype):
    """The port's index builder and the plain int8 scorer against
    build_q8_index + fused_clip_scores_q8 (Pallas, interpret mode) on the
    same quantized rows: valid-video columns bitwise equal."""
    q, ctx, mask = _inputs(nq, nv, l_frames, d)
    qj = jnp.asarray(q).astype(dtype)
    rows = jax_sm.quantize_frames_q8(jnp.asarray(ctx).astype(dtype))
    ctx_t, bias = jax_sm.build_q8_index(rows, jnp.asarray(mask))
    want = np.asarray(jax_sim.clip_scores_maxpool_pre8(
        qj, ctx_t, bias, prefer_pallas=True, interpret=True))[:, :nv]

    c8, b8 = sim_max.build_q8_index(torch.from_numpy(np.array(rows)),
                                    _t(mask))
    assert c8.dtype == torch.int8 and b8.dtype == torch.int32
    assert tuple(b8.shape) == (nv, l_frames)
    valid = _valid(mask)
    # the scorer on the query components each JAX route quantizes: the
    # Pallas wrapper inside a jitted program, the XLA twin eagerly (bf16
    # norms may round differently in the two, tests/test_fast_eval.py)
    xla = np.asarray(jax_sim.clip_scores_maxpool_pre8(
        qj, ctx_t, bias, prefer_pallas=False))[:, :nv]

    def quantize(x):
        return jax_sm.quantize_unit_int8(jax_masking.l2_normalize(x))

    for q8, ref in ((jax.jit(quantize)(qj), want), (quantize(qj), xla)):
        got = sim_max.fused_clip_scores_int8(
            torch.from_numpy(np.array(q8)), c8, b8).numpy()
        np.testing.assert_array_equal(got[:, valid], ref[:, valid])
        assert np.all(got[:, ~valid] < -6e4)   # the dequantized mask bias
    # and the whole wrapper, query normalization included: bitwise in f32;
    # in bf16 the port's l2_normalize rounds the squares as the jaxpr of
    # jnp.linalg.norm does and XLA's CPU backend does not (ROADMAP C), so
    # a query component may move one level (8e-3 as in test_torch_ops)
    e2e = similarity.clip_scores_maxpool_pre8(_t(q, getattr(torch, dtype)),
                                              c8, b8).numpy()
    if dtype == "float32":
        np.testing.assert_array_equal(e2e[:, valid], want[:, valid])
    else:
        np.testing.assert_allclose(e2e[:, valid], want[:, valid], atol=8e-3,
                                   rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_maxpool_matches_jax(dtype):
    """clip_scores_maxpool(quantized=True) and its plain twin against the
    JAX package's `_quantized_scores_xla` (bitwise, all columns) and the
    Pallas quantized kernel (bitwise, valid columns)."""
    q, ctx, mask = _inputs(9, 21, 6, 16, seed=2)
    qj, cj = jnp.asarray(q).astype(dtype), jnp.asarray(ctx).astype(dtype)
    want = np.asarray(jax_sim._quantized_scores_xla(qj, cj,
                                                    jnp.asarray(mask)))
    tdt = getattr(torch, dtype)
    got = similarity.clip_scores_maxpool(_t(q, tdt), _t(ctx, tdt), _t(mask),
                                         quantized=True).numpy()
    twin = similarity._quantized_scores_plain(_t(q, tdt), _t(ctx, tdt),
                                              _t(mask)).numpy()
    if dtype == "float32":
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(twin, want)
    pallas = np.asarray(jax_sim.clip_scores_maxpool(
        qj, cj, jnp.asarray(mask), prefer_pallas=True, quantized=True,
        interpret=True))
    valid = _valid(mask)
    if dtype == "float32":
        np.testing.assert_array_equal(got[:, valid], pallas[:, valid])
    else:
        # the bf16 norm sum rounds per the knife-edge contract: a flipped
        # component moves a score by at most 127/127^2 per frame product
        np.testing.assert_allclose(got[:, valid], pallas[:, valid],
                                   atol=2 * 127 / 127.0 ** 2, rtol=0)
    np.testing.assert_array_equal(got, twin)


def test_int8_wrapper_checks_inputs_and_counts_no_cpu_launch():
    q8 = torch.zeros((3, 8), dtype=torch.int8)
    c8 = torch.zeros((4, 5, 8), dtype=torch.int8)
    bias = torch.zeros((4, 5), dtype=torch.int32)
    before = dict(sim_max.LAUNCHES)
    out = sim_max.fused_clip_scores_int8(q8, c8, bias)
    assert tuple(out.shape) == (3, 4) and sim_max.LAUNCHES == before
    with pytest.raises(ValueError, match="int8, int8, int32"):
        sim_max.fused_clip_scores_int8(q8, c8, bias.float())
    with pytest.raises(ValueError, match="shape"):
        sim_max.fused_clip_scores_int8(q8, c8, bias[:, :4])
    with pytest.raises(ValueError, match="int8 rows"):
        sim_max.build_q8_index(c8.float(), bias)


# ---------------------------------------------------------- exact scoring

def test_exact_scores_plain_matches_pallas():
    """fused_exact_scores' plain version against the split-3 Pallas kernel
    (interpret mode, padded tile grid) on bf16-stored frames."""
    q, ctx, mask = _inputs(9, 13, 5, 16, seed=11)
    ctx16 = jnp.asarray(ctx).astype(jnp.bfloat16)
    nq_p, nv_p, l_p = 256, 128, 16
    want = np.asarray(jax_sm.fused_exact_scores(
        jnp.pad(jnp.asarray(q), ((0, nq_p - 9), (0, 0))),
        jnp.pad(ctx16, ((0, nv_p - 13), (0, l_p - 5), (0, 0))),
        jnp.pad(jnp.asarray(mask), ((0, nv_p - 13), (0, l_p - 5))),
        q_tile=256, l_tile=16, interpret=True))[:9, :13]
    ctx_t = _t(ctx).to(torch.bfloat16)
    before = dict(sim_max.LAUNCHES)
    got = sim_max.fused_exact_scores(_t(q), ctx_t, _t(mask)).numpy()
    assert sim_max.LAUNCHES == before
    valid = _valid(mask)
    np.testing.assert_allclose(got[:, valid], want[:, valid],
                               atol=EXACT_TOL, rtol=0)
    assert np.all(got[:, ~valid] <= -1e9)
    with pytest.raises(ValueError, match="bf16-stored"):
        sim_max.fused_exact_scores(_t(q), _t(ctx), _t(mask))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exact_clip_scores_and_rescore_shortlist_match_jax(dtype):
    """exact_clip_scores (f32 frames: the f32 masked-cosine route; bf16:
    the exact kernel's plain version) and rescore_shortlist (candidate
    gather, query count not a multiple of the chunk) against the JAX
    functions."""
    q, ctx, mask = _inputs(11, 20, 6, 8, seed=1)
    rng = np.random.RandomState(5)
    cand = np.stack([rng.choice(20, 7, replace=False) for _ in range(11)])
    qj, cj = jnp.asarray(q), jnp.asarray(ctx).astype(dtype)
    tq, tc = _t(q), _t(ctx, getattr(torch, dtype))
    want = np.asarray(jax_sim.exact_clip_scores(qj, cj, jnp.asarray(mask),
                                                prefer_pallas=False))
    got = similarity.exact_clip_scores(tq, tc, _t(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=EXACT_TOL, rtol=0)
    want_r = np.asarray(jax_sim.rescore_shortlist(
        qj, cj, jnp.asarray(mask), jnp.asarray(cand), chunk=4))
    got_r = similarity.rescore_shortlist(tq, tc, _t(mask),
                                         torch.from_numpy(cand), chunk=4)
    assert got_r.dtype == torch.float32 and tuple(got_r.shape) == (11, 7)
    np.testing.assert_allclose(got_r.numpy(), want_r, atol=EXACT_TOL, rtol=0)
    # the shortlist scores are the dense scores' columns
    np.testing.assert_allclose(got_r.numpy(),
                               np.take_along_axis(got, cand, axis=1),
                               atol=EXACT_TOL, rtol=0)


def test_dense_rescore_mode_and_override(monkeypatch):
    """The mode knob reads like the JAX package's, pins the dispatch either
    way, and a bad value raises."""
    for value, mode in (("never", "never"), ("0", "never"),
                        (" Always ", "always"), ("true", "always"),
                        ("", "auto"), ("auto", "auto")):
        monkeypatch.setenv("DLDKD_DENSE_RESCORE", value)
        assert similarity.dense_rescore_mode() == mode \
            == jax_sim.dense_rescore_mode()
    monkeypatch.delenv("DLDKD_DENSE_RESCORE")
    assert similarity.dense_rescore_mode() == "auto"
    big, small = (1024, 40, 2304, 128, 384, 2), (8, 20, 64, 8, 16, 4)
    monkeypatch.setenv("DLDKD_DENSE_RESCORE", "never")
    assert not similarity.dense_rescore_wins(*big)
    assert not similarity.dense_rescore_wins(*small)
    monkeypatch.setenv("DLDKD_DENSE_RESCORE", "always")
    assert similarity.dense_rescore_wins(*big)
    assert similarity.dense_rescore_wins(*small)
    monkeypatch.setenv("DLDKD_DENSE_RESCORE", "alwys")
    with pytest.raises(ValueError, match="DLDKD_DENSE_RESCORE"):
        similarity.dense_rescore_wins(*big)


def test_dense_rescore_cost_model_regimes(monkeypatch):
    """With the port's own constants: the gather wins for few queries
    against a large corpus, dense scoring for many queries against a
    small one."""
    monkeypatch.delenv("DLDKD_DENSE_RESCORE", raising=False)
    assert not similarity.dense_rescore_wins(8, 40, 18432, 128, 384, 2)
    assert similarity.dense_rescore_wins(4096, 40, 64, 128, 384, 2)


def test_clip_scores_unnormalized_matches_jax():
    q, ctx, mask = _inputs(5, 6, 4, 8, seed=4)
    want = jax_sim.clip_scores_unnormalized(jnp.asarray(q), jnp.asarray(ctx),
                                            jnp.asarray(mask))
    got = similarity.clip_scores_unnormalized(_t(q), _t(ctx), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


# ------------------------------------------------- towers' int8 epilogue

_DIMS = dict(visual_input_size=24, query_input_size=16, inheritance_hidden=16,
             exploration_hidden=16, max_ctx_l=8, max_desc_l=6, n_heads=2)


@pytest.mark.parametrize("double", [True, False], ids=["dual", "one"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_context_q8_matches_pallas(dtype, double):
    """encode_context_q8 through the plain towers and epilogue (two-branch
    launch, and one-branch for a single-branch model) against the JAX
    package's Pallas towers with emit_q8 in interpret mode: f32 exact,
    bf16 within the knife-edge contract. emit_q8 counts no CPU launch."""
    jcfg = JaxModelConfig(double_branch=double, dtype=dtype, **_DIMS)
    params = init_params(JaxDLDKD(config=jcfg), jcfg, 0)
    model = load_jax_params(
        DLDKD(ModelConfig(double_branch=double, dtype=dtype, **_DIMS)),
        jax.tree.map(np.asarray, params)).eval()
    rng = np.random.RandomState(8)
    vf = rng.randn(5, 8, 24).astype(np.float32)
    vm = np.ones((5, 8), np.float32)
    vm[1, 5:] = 0.0
    vm[4] = 0.0
    want = jax_fast_eval.encode_context_q8(params, jcfg, jnp.asarray(vf),
                                           jnp.asarray(vm),
                                           prefer_pallas=True, interpret=True)
    before = dict(qt.LAUNCHES)
    got = fast_eval.encode_context_q8(model, _t(vf), _t(vm))
    assert qt.LAUNCHES == before
    assert (got[1] is None) == (want[1] is None) == (not double)
    for g, w in zip(got, want):
        if w is None:
            continue
        assert g.dtype == torch.int8 and tuple(g.shape) == (5, 8, 16)
        if dtype == "float32":
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            _assert_q8_equal_mod_knife_edge(g.numpy(), w)
    # emit_q8 is the epilogue applied to the towers' own frames
    frames = fast_eval.encode_context_best(model, _t(vf), _t(vm))
    for g, f in zip(got, frames):
        if f is not None:
            assert torch.equal(g, qt.quantize_frames_q8_plain(f))
            assert torch.equal(g, qt.quantize_frames_q8(f))
    # and the canonical quantization of the port's frames is within one
    # level of the port's masking.l2_normalize followed by quantization
    for g, f in zip(got, frames):
        if f is not None:
            alt = qt.quantize_unit_int8(l2_normalize(f))
            assert (g.int() - alt.int()).abs().max() <= 1
