"""The port's model and inference towers against the JAX package: the
DLDKD module against `model.apply(method="encode_*")`, `encode_*_fast`
against their JAX twins, and the tower kernels' plain versions against the
Pallas tower kernels (`fused_*_tower_dual` and the one-branch
`fused_*_tower`, interpret mode) through `encode_*_best`.

Sizes: d_student 64, d_query 48, hidden 32, 4 heads, 16 frames and a
12-token positional table, so queries pad to the 8-token grid (16) and the
grid tail past the table is exercised. Weights are random normal x 0.5 so
the LayerNorm affines matter.

Tolerances:
- f32: 2e-5 abs (5e-5 on the towers' frame features, whose values reach
  ~10): same operations, sums taken in another order.
- bf16: 5e-2 abs plus 1.6e-2 rel (two bf16 ulps): the same rounding points
  as the Pallas kernel, but another f32 accumulation order now and then
  puts an intermediate on the other side of a bf16 rounding boundary. One
  such flip in a hidden value of magnitude 2-4 (ulp 2**-7 to 2**-6) moves
  a near-zero output of the next product (weights ~0.5) by up to ~3e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dldkd_tpu.config import ModelConfig as JaxModelConfig
from dldkd_tpu.models import DLDKD as JaxDLDKD
from dldkd_tpu.ops import fast_eval as jax_fast
from dldkd_tpu.ops.pallas import query_tower as jax_qt
from dldkd_tpu.train import init_params
from dldkd_tpu_torch.config import ModelConfig
from dldkd_tpu_torch.convert import load_jax_params
from dldkd_tpu_torch.models import DLDKD
from dldkd_tpu_torch.ops import fast_eval
from dldkd_tpu_torch.ops.kernels import query_tower as qt

F32_TOL = 2e-5
F32_FRAME_TOL = 5e-5
BF16_ATOL, BF16_RTOL = 5e-2, 1.6e-2

_SMALL = dict(visual_input_size=64, query_input_size=48, inheritance_hidden=32,
              max_ctx_l=16, max_desc_l=12, n_heads=4)
# double: the two-branch launch; unequal: one-branch launches with the
# smaller table as tail cap; single: a one-branch model
_VARIANTS = {"double": dict(double_branch=True, exploration_hidden=32),
             "unequal": dict(double_branch=True, exploration_hidden=16),
             "single": dict(double_branch=False, exploration_hidden=32)}


@pytest.fixture(autouse=True, scope="module")
def _torch_numerics():
    threads = torch.get_num_threads()
    precision = torch.get_float32_matmul_precision()
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(threads)
    torch.set_float32_matmul_precision(precision)


def _models(variant: str, dtype: str = "float32"):
    kw = dict(_SMALL, dtype=dtype, **_VARIANTS[variant])
    jcfg = JaxModelConfig(**kw)
    jmodel = JaxDLDKD(config=jcfg)
    params = init_params(jmodel, jcfg, 0)
    leaves, tree = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(7), len(leaves))
    params = jax.tree.unflatten(tree, [
        jax.random.normal(k, leaf.shape, leaf.dtype) * 0.5
        for k, leaf in zip(keys, leaves)])
    model = load_jax_params(DLDKD(ModelConfig(**kw)),
                            jax.tree.map(np.asarray, params)).eval()
    return jmodel, params, model


def _data(n_videos=9, n_queries=11, lq=12):
    rng = np.random.RandomState(1)
    vf = rng.randn(n_videos, 16, 64).astype(np.float32) * 3
    vm = np.ones((n_videos, 16), np.float32)
    vm[2, 5:] = 0.0
    vm[4] = 0.0                      # an all-masked (padding) video
    qf = rng.randn(n_queries, lq, 48).astype(np.float32)
    qm = np.ones((n_queries, lq), np.float32)
    qm[0, 2:] = 0.0
    qm[3] = 0.0                      # an all-masked (padding) query
    return vf, vm, qf, qm


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _close(got, want, dtype, atol=F32_TOL):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert np.isfinite(got).all()
    if dtype == "bfloat16":
        np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=BF16_RTOL)
    else:
        np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _pair_close(got, want, dtype, atol=F32_TOL):
    assert (got[1] is None) == (want[1] is None)
    _close(got[0], want[0], dtype, atol)
    if want[1] is not None:
        _close(got[1], want[1], dtype, atol)


@pytest.mark.parametrize("variant", ["double", "single"])
def test_model_encoders_match_flax(variant):
    jmodel, params, model = _models(variant)
    vf, vm, qf, qm = _data()
    with torch.no_grad():
        got_c = model.encode_context(_t(vf), _t(vm))
        got_q = model.encode_query(_t(qf), _t(qm))
    want_c = jmodel.apply(params, jnp.asarray(vf), jnp.asarray(vm),
                          deterministic=True, method="encode_context")
    want_q = jmodel.apply(params, jnp.asarray(qf), jnp.asarray(qm),
                          deterministic=True, method="encode_query")
    _pair_close(got_c, want_c, "float32", F32_FRAME_TOL)
    _pair_close(got_q, want_q, "float32")


def test_dropout_only_in_train_mode():
    """Dropout acts in training mode only, with masks from the generator
    the caller passes (models/components.py:Dropout)."""
    from dldkd_tpu_torch.models.components import Dropout

    _, _, model = _models("double")
    vf, vm, _, _ = _data()
    with torch.no_grad():
        a = model.encode_context(_t(vf), _t(vm))[0]
        model.train()
        b = model.encode_context(_t(vf), _t(vm),
                                 generator=torch.Generator().manual_seed(0))[0]
        model.eval()
    assert not torch.equal(a, b)
    assert len([m for m in model.modules()
                if isinstance(m, Dropout)]) == 2 * 2 * 4


@pytest.mark.parametrize("variant", list(_VARIANTS))
def test_fast_towers_match_jax_fast(variant):
    jmodel, params, model = _models(variant)
    vf, vm, qf, qm = _data()
    _pair_close(fast_eval.encode_context_fast(model, _t(vf), _t(vm)),
                jax_fast.encode_context_fast(params, jmodel.config,
                                             jnp.asarray(vf),
                                             jnp.asarray(vm)),
                "float32", F32_FRAME_TOL)
    _pair_close(fast_eval.encode_query_fast(model, _t(qf), _t(qm)),
                jax_fast.encode_query_fast(params, jmodel.config,
                                           jnp.asarray(qf), jnp.asarray(qm)),
                "float32")


def test_weight_tuples_match_jax():
    jmodel, params, model = _models("double")
    for ours, theirs in ((fast_eval.weights_for_branch,
                          jax_qt.weights_for_branch),
                         (fast_eval.context_weights_for_branch,
                          jax_qt.context_weights_for_branch)):
        for branch in ("inheritance", "exploration"):
            got = ours(model, branch, torch.float32)
            want = theirs(params, branch, jnp.float32)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", list(_VARIANTS))
def test_query_tower_plain_matches_pallas(variant, dtype):
    """The query tower's plain version against `fused_query_tower_dual`
    (double) or the one-branch `fused_query_tower` (unequal, single), with
    12 tokens padded to the 16-token grid past the 12-row table."""
    jmodel, params, model = _models(variant, dtype)
    _, _, qf, qm = _data()
    want = jax_fast.encode_query_best(params, jmodel.config,
                                      jnp.asarray(qf), jnp.asarray(qm),
                                      prefer_pallas=True, interpret=True)
    got = fast_eval.encode_query_best(model, _t(qf), _t(qm))
    assert got[0].dtype == getattr(torch, dtype)
    _pair_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", list(_VARIANTS))
def test_context_tower_plain_matches_pallas(variant, dtype):
    jmodel, params, model = _models(variant, dtype)
    vf, vm, _, _ = _data()
    want = jax_fast.encode_context_best(params, jmodel.config,
                                        jnp.asarray(vf), jnp.asarray(vm),
                                        prefer_pallas=True, interpret=True)
    got = fast_eval.encode_context_best(model, _t(vf), _t(vm))
    assert got[0].dtype == getattr(torch, dtype)
    _pair_close(got, want, dtype, F32_FRAME_TOL)


def test_grid_tail_tokens_are_padding():
    """A 16-token buffer on a 12-row table is accepted (8-token grid) and
    tokens 12..15 count as padding whatever their mask says; 17 tokens
    raise, as in the JAX package."""
    _, _, model = _models("double")
    _, _, qf, qm = _data(lq=16)
    qm[:, 12:] = 1.0
    # a row with no valid token attends uniformly to every key, tail
    # included, in the JAX package too: give each row a valid token
    qm[:, 0] = 1.0
    base = fast_eval.encode_query_best(model, _t(qf), _t(qm))
    qf2 = qf.copy()
    qf2[:, 12:] = 123.0
    tail = fast_eval.encode_query_best(model, _t(qf2), _t(qm))
    for a, b in zip(base, tail):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    fast = fast_eval.encode_query_fast(model, _t(qf), _t(qm))
    for a, b in zip(base, fast):
        torch.testing.assert_close(a, b, atol=F32_TOL, rtol=0)
    _, _, qf3, qm3 = _data(lq=17)
    with pytest.raises(ValueError, match="positional"):
        fast_eval.encode_query_best(model, _t(qf3), _t(qm3))


def test_tower_wrappers_check_inputs_and_count_no_cpu_launch():
    _, _, model = _models("double")
    vf, vm, qf, qm = _data()
    ws = fast_eval.tower_weights(model)
    before = dict(qt.LAUNCHES)
    qt.fused_context_tower_dual(_t(vf), _t(vm), *ws["context"], n_heads=4,
                                dtype=torch.float32)
    assert qt.LAUNCHES == before          # CPU: the plain version
    with pytest.raises(ValueError, match="f32"):
        qt.fused_query_tower(_t(qf).double(), _t(qm), ws["query"][0], 4)
    with pytest.raises(ValueError, match="mask"):
        qt.fused_query_tower(_t(qf), _t(qm)[:, :5], ws["query"][0], 4)
    with pytest.raises(ValueError, match="input width"):
        qt.fused_context_tower(_t(vf)[..., :10], _t(vm), ws["context"][0], 4)
    with pytest.raises(ValueError, match="tower dtype"):
        qt.fused_context_tower(_t(vf), _t(vm), ws["context"][0], 4,
                               dtype=torch.float16)
