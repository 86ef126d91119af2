"""The PyTorch port's ops against the JAX package: masking, similarity,
the scoring kernel's plain version against the Pallas `_sim_max_kernel`
(interpret mode), ranks and metrics, the weight converter and the
checkpoint reader/writer.

Tolerances:
- The scoring kernel's plain version on the normalized inputs the Pallas
  wrapper builds: 2e-5 abs in f32 and bf16. Same products (bf16 widens
  exactly to f32), sums taken in another order.
- l2_normalize, f32: 1e-6 abs, one f32 ulp of a unit vector's entries from
  the order of the sum of squares.
- l2_normalize, bf16: one bf16 ulp of a unit entry (2**-8). The port rounds
  the squares to bf16 as the jaxpr of jnp.linalg.norm does; XLA's CPU
  backend fuses that product into the f32 convert and skips the rounding.
- End-to-end bf16 scores: 8e-3 abs, the one-ulp normalization difference
  above carried through a dot product of unit vectors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dldkd_tpu import checkpoint as jax_ckpt
from dldkd_tpu import metrics as jax_metrics
from dldkd_tpu.config import ModelConfig as JaxModelConfig
from dldkd_tpu.convert import flax_to_torch_state_dict
from dldkd_tpu.models import DLDKD as JaxDLDKD
from dldkd_tpu.ops import masking as jax_masking
from dldkd_tpu.ops import similarity as jax_sim
from dldkd_tpu.train import init_params
from dldkd_tpu_torch import checkpoint as ckpt
from dldkd_tpu_torch import metrics
from dldkd_tpu_torch.config import ModelConfig
from dldkd_tpu_torch.convert import (load_jax_params, params_from_state_dict,
                                     state_dict_from_jax)
from dldkd_tpu_torch.models import DLDKD
from dldkd_tpu_torch.ops import masking, similarity
from dldkd_tpu_torch.ops.kernels import sim_max

F32_TOL = 2e-5
BF16_NORM_TOL = 2.0 ** -8
BF16_SCORE_TOL = 8e-3


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


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _scoring_inputs(nq, nv, l_frames, d, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(nq, d).astype(np.float32)
    ctx = rng.randn(nv, l_frames, d).astype(np.float32)
    mask = (rng.rand(nv, l_frames) < 0.7).astype(np.float32)
    mask[:, 0] = 1.0
    mask[min(3, nv - 1)] = 0.0       # an all-masked (padding) video
    return q, ctx, mask


# ---------------------------------------------------------------- masking

def test_mask_logits_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(5, 7).astype(np.float32)
    m = (rng.rand(5, 7) < 0.5).astype(np.float32)
    want = jax_masking.mask_logits(jnp.asarray(x), jnp.asarray(m))
    got = masking.mask_logits(_t(x), _t(m))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_l2_normalize_matches_jax(dtype):
    rng = np.random.RandomState(1)
    x = rng.randn(6, 9, 40).astype(np.float32) * 3
    x[0, 0] = 0.0                    # the eps clamp
    want = jax_masking.l2_normalize(jnp.asarray(x).astype(dtype))
    got = masking.l2_normalize(_t(x, getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    atol = BF16_NORM_TOL if dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


# ------------------------------------------------------------- similarity

def test_frame_similarity_and_clip_scores_match_jax():
    q, ctx, mask = _scoring_inputs(6, 5, 7, 16)
    want_max, want_frame = jax_sim.clip_scores(
        jnp.asarray(q), jnp.asarray(ctx), jnp.asarray(mask))
    got_max, got_frame = similarity.clip_scores(_t(q), _t(ctx), _t(mask))
    assert tuple(got_frame.shape) == (6, 7, 5)
    np.testing.assert_allclose(got_frame.numpy(), np.asarray(want_frame),
                               atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(got_max.numpy(), np.asarray(want_max),
                               atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nq,nv,l_frames,d", [(16, 128, 16, 32),
                                              (7, 130, 9, 32),
                                              (50, 37, 5, 24)])
def test_plain_maxpool_matches_pallas_kernel(nq, nv, l_frames, d, dtype):
    """The kernel's plain version against the Pallas `_sim_max_kernel` in
    interpret mode, on shapes that are not tile multiples and with an
    all-masked video."""
    q, ctx, mask = _scoring_inputs(nq, nv, l_frames, d)
    qj = jnp.asarray(q).astype(dtype)
    cj = jnp.asarray(ctx).astype(dtype)
    want = jax_sim.clip_scores_maxpool(qj, cj, jnp.asarray(mask),
                                       prefer_pallas=True, interpret=True)
    tdt = getattr(torch, dtype)
    # the kernel's function on the inputs the Pallas wrapper normalizes
    qn = _t(jax_masking.l2_normalize(qj), tdt)
    cn = _t(jax_masking.l2_normalize(cj), tdt)
    got = sim_max.fused_clip_scores(qn, cn, _t(mask))
    assert got.dtype == torch.float32 and tuple(got.shape) == (nq, nv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=0)
    # and the whole of clip_scores_maxpool, normalization included
    e2e = similarity.clip_scores_maxpool(_t(q, tdt), _t(ctx, tdt), _t(mask))
    tol = F32_TOL if dtype == "float32" else BF16_SCORE_TOL
    np.testing.assert_allclose(e2e.numpy(), np.asarray(want), atol=tol,
                               rtol=0)
    assert np.all(e2e.numpy()[:, min(3, nv - 1)] <= -1e9)
    if dtype == "float32":
        ref, _ = jax_sim.clip_scores(qj, cj, jnp.asarray(mask))
        np.testing.assert_allclose(e2e.numpy(), np.asarray(ref),
                                   atol=F32_TOL, rtol=0)


def test_plain_maxpool_chunks_queries(monkeypatch):
    """The plain version never builds the whole (Nq, Nv, L) tensor: with a
    small chunk budget it scores in several query chunks, same result."""
    q, ctx, mask = _scoring_inputs(23, 11, 6, 16)
    qn, cn = masking.l2_normalize(_t(q)), masking.l2_normalize(_t(ctx))
    whole = sim_max.sim_max_plain(qn, cn, _t(mask))
    monkeypatch.setattr(sim_max, "_PLAIN_CHUNK_BYTES", 11 * 6 * 4 * 5)
    chunked = sim_max.sim_max_plain(qn, cn, _t(mask))
    np.testing.assert_array_equal(chunked.numpy(), whole.numpy())


def test_scoring_wrapper_checks_inputs_and_counts_no_cpu_launch():
    q, ctx, mask = _scoring_inputs(4, 3, 5, 8)
    before = sim_max.LAUNCHES["sim_max"]
    sim_max.fused_clip_scores(_t(q), _t(ctx), _t(mask))
    assert sim_max.LAUNCHES["sim_max"] == before   # CPU: the plain version
    with pytest.raises(ValueError, match="one dtype"):
        sim_max.fused_clip_scores(_t(q, torch.bfloat16), _t(ctx), _t(mask))
    with pytest.raises(ValueError, match="shape"):
        sim_max.fused_clip_scores(_t(q), _t(ctx), _t(mask[:, :4]))
    with pytest.raises(ValueError, match="contiguous"):
        sim_max.fused_clip_scores(_t(q), _t(ctx).transpose(0, 1), _t(mask.T))


# ------------------------------------------------------- ranks and metrics

def test_rank_of_gt_exact_ties():
    """Ties break by corpus index, as a stable descending sort does."""
    scores = np.asarray([[0.5, 0.9, 0.5, 0.5, 0.1],
                         [0.5, 0.9, 0.5, 0.5, 0.1],
                         [0.5, 0.9, 0.5, 0.5, 0.1],
                         [0.2, 0.2, 0.2, 0.2, 0.2],
                         [0.2, 0.2, 0.2, 0.2, 0.2]], np.float32)
    gt = np.asarray([0, 2, 3, 0, 4], np.int32)
    got = metrics.rank_of_gt(_t(scores), torch.from_numpy(gt))
    want = jax_metrics.rank_of_gt(jnp.asarray(scores), jnp.asarray(gt))
    stable = [1 + list(np.argsort(-s, kind="stable")).index(g)
              for s, g in zip(scores, gt)]
    assert got.dtype == torch.int32
    assert got.tolist() == [2, 3, 4, 1, 5] == list(np.asarray(want)) \
        == stable


def test_rank_of_gt_random_matches_jax():
    rng = np.random.RandomState(4)
    scores = np.round(rng.randn(40, 30), 1).astype(np.float32)  # many ties
    gt = rng.randint(0, 30, 40).astype(np.int32)
    got = metrics.rank_of_gt(_t(scores), torch.from_numpy(gt))
    want = jax_metrics.rank_of_gt(jnp.asarray(scores), jnp.asarray(gt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_metrics_from_ranks_and_gt_indices_match_jax():
    ranks = np.asarray([1, 3, 7, 12, 150, 2], np.int32)
    assert metrics.metrics_from_ranks(ranks) == \
        jax_metrics.metrics_from_ranks(ranks)
    corpus = ["v3", "v1", "v2"]
    q_ids = ["v1", "v2", "v1", "v3"]
    np.testing.assert_array_equal(
        metrics.build_gt_indices(q_ids, corpus),
        jax_metrics.build_gt_indices(q_ids, corpus))


# ------------------------------------------------- weights and checkpoints

_SMALL = dict(visual_input_size=64, query_input_size=48, inheritance_hidden=32,
              exploration_hidden=32, max_ctx_l=16, max_desc_l=12, n_heads=4)


@pytest.fixture(scope="module", params=[True, False], ids=["double",
                                                           "single"])
def jax_params(request):
    cfg = JaxModelConfig(double_branch=request.param, **_SMALL)
    params = init_params(JaxDLDKD(config=cfg), cfg, 0)
    return cfg, jax.tree.map(np.asarray, params)


def test_state_dict_from_jax_matches_reference_converter(jax_params):
    """Name for name and value for value with the JAX package's own
    converter, and a strict load into the port's DLDKD."""
    cfg, params = jax_params
    got = state_dict_from_jax(params)
    want = flax_to_torch_state_dict(params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    model = DLDKD(ModelConfig(double_branch=cfg.double_branch, **_SMALL))
    assert set(model.state_dict()) == set(want)
    load_jax_params(model, params)     # strict=True
    back = params_from_state_dict(model.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_reads_checkpoint_written_by_jax(jax_params, tmp_path):
    cfg, params = jax_params
    state = {"params": jax.tree.map(jnp.asarray, params), "opt_state": {},
             "epoch": 7, "best_score": 123.5,
             "rng": np.zeros(2, np.uint32)}
    jax_ckpt.save_checkpoint(str(tmp_path), state, cfg)
    got, epoch = ckpt.restore_params_only(str(tmp_path))
    assert epoch == 7
    assert jax.tree.structure(got) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    assert ckpt.load_model_cfg(str(tmp_path)) == ModelConfig(
        **{k: getattr(cfg, k) for k in cfg.__dataclass_fields__})


def test_checkpoint_written_by_port_restores_in_jax(jax_params, tmp_path):
    cfg, params = jax_params
    ckpt.save_checkpoint(str(tmp_path), {
        "params": params, "opt_state": {}, "epoch": 3, "best_score": 1.5,
        "rng": np.zeros(2, np.uint32)}, ModelConfig(
            double_branch=cfg.double_branch, **_SMALL))
    template = init_params(JaxDLDKD(config=cfg), cfg, 1)
    got, epoch = jax_ckpt.restore_params_only(str(tmp_path), template)
    assert epoch == 3
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert jax_ckpt.load_model_cfg(str(tmp_path)) == cfg
