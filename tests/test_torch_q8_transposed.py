"""The video towers' transposed int8 emission
(`fused_context_tower_dual(emit_q8=True, q8_transposed=True)`, the last mode
of a TPU kernel) on the CPU: its plain version against the Pallas dual
context tower in interpret mode, as tests/test_pallas.py:265-316 checks the
TPU kernel, and the TPU index grid's helpers against the JAX package's.

Tolerances: f32 towers give the Pallas kernel's int8 rows exactly (the
valid region and the computed padding alike); bf16 rows follow the
knife-edge contract of tests/test_fast_eval.py (a flipped bf16 norm
rounding moves an entry by at most one level, on a small share); the bias
and the tile policy are bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dldkd_tpu.config import ModelConfig as JaxModelConfig
from dldkd_tpu.models import DLDKD as JaxDLDKD
from dldkd_tpu.ops.pallas import query_tower as jax_qt
from dldkd_tpu.ops.pallas import sim_max as jax_sm
from dldkd_tpu.train import init_params
from dldkd_tpu_torch.config import ModelConfig
from dldkd_tpu_torch.convert import load_jax_params
from dldkd_tpu_torch.models import DLDKD
from dldkd_tpu_torch.ops import fast_eval
from dldkd_tpu_torch.ops.kernels import query_tower as qt
from dldkd_tpu_torch.ops.kernels import sim_max
from tests.test_fast_eval import _assert_q8_equal_mod_knife_edge

NV, LV, DV, H = 9, 12, 40, 16


@pytest.fixture(autouse=True, scope="module")
def _torch_numerics():
    threads = torch.get_num_threads()
    precision = torch.get_float32_matmul_precision()
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(threads)
    torch.set_float32_matmul_precision(precision)


def _inputs():
    rng = np.random.RandomState(1)
    vf = rng.randn(NV, LV, DV).astype(np.float32) * 3
    vm = np.ones((NV, LV), np.float32)
    vm[2, 5:] = 0.0
    vm[7] = 0.0                      # an all-masked video
    return vf, vm


_DIMS = dict(visual_input_size=DV, query_input_size=24,
             inheritance_hidden=H, exploration_hidden=H, max_ctx_l=LV,
             max_desc_l=6, n_heads=2, double_branch=True)


@pytest.fixture(scope="module")
def params():
    """f32 parameters; each test casts the towers' weights to its dtype."""
    jcfg = JaxModelConfig(**_DIMS)
    return init_params(JaxDLDKD(config=jcfg), jcfg, 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q8_transposed_plain_matches_pallas(params, dtype):
    """The port's padded (L_p, Nv_p, H) int8 pair against the Pallas
    kernel's, padding included; its bias against JAX's; and the valid
    region is the non-transposed emission's rows."""
    model = load_jax_params(DLDKD(ModelConfig(**_DIMS, dtype=dtype)),
                            jax.tree.map(np.asarray, params)).eval()
    vf, vm = _inputs()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_qt.fused_context_tower_dual(
        jnp.asarray(vf), jnp.asarray(vm),
        jax_qt.context_weights_for_branch(params, "inheritance", jdt),
        jax_qt.context_weights_for_branch(params, "exploration", jdt),
        n_heads=2, dtype_name=dtype, emit_q8=True, q8_transposed=True,
        interpret=True)
    wa = fast_eval.context_weights_for_branch(model, "inheritance", tdt)
    wb = fast_eval.context_weights_for_branch(model, "exploration", tdt)
    x, m = torch.from_numpy(vf), torch.from_numpy(vm)
    before = dict(qt.LAUNCHES)
    got = qt.fused_context_tower_dual(x, m, wa, wb, 2, tdt, emit_q8=True,
                                      q8_transposed=True)
    assert qt.LAUNCHES == before        # the CPU runs the plain version
    l_p, nv_p = 16, 128                 # frames to max(8, 16), videos to 128
    for g, w in zip(got, want):
        assert g.dtype == torch.int8 and tuple(g.shape) == (l_p, nv_p, H)
        assert tuple(w.shape) == (l_p, nv_p, H)
        if dtype == "float32":
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            _assert_q8_equal_mod_knife_edge(g.numpy(), w)
    bias = sim_max.q8_index_bias(m, l_p, nv_p)
    np.testing.assert_array_equal(
        bias.numpy(), np.asarray(jax_sm.q8_index_bias(jnp.asarray(vm), l_p,
                                                      nv_p)))
    # the real videos' rows are the untransposed emission's on the same
    # padded frames (positions past LV zero), transposed
    pad = l_p - LV
    rows = qt._run(F.pad(x, (0, 0, 0, pad)), F.pad(m, (0, pad)), [wa, wb],
                   2, tdt, "context", LV, plain=True, emit_q8=True)
    for g, r in zip(got, rows):
        assert torch.equal(g[:, :NV], r.permute(1, 0, 2))
    # without emit_q8 the flag is ignored (query_tower.py:455)
    plain = qt.fused_context_tower_dual(x, m, wa, wb, 2, tdt,
                                        q8_transposed=True)
    assert plain[0].dtype == tdt and tuple(plain[0].shape) == (NV, LV, H)


def test_q8_index_bias_and_tile_match_jax():
    rng = np.random.RandomState(2)
    mask = (rng.rand(5, 7) < 0.6).astype(np.float32)
    for l_p, nv_p in ((8, 128), (16, 256), (7, 5)):
        np.testing.assert_array_equal(
            sim_max.q8_index_bias(torch.from_numpy(mask), l_p, nv_p).numpy(),
            np.asarray(jax_sm.q8_index_bias(jnp.asarray(mask), l_p, nv_p)))
    # without a grid: the port's own (Nv, L) layout, unchanged
    assert tuple(sim_max.q8_index_bias(torch.from_numpy(mask)).shape) \
        == (5, 7)
    assert sim_max.V_LANES == jax_sm.V_LANES
    for d in (8, 16, 384, 1024, 2048, 4096, 9000, 40000):
        assert sim_max.pick_q8_l_tile(d) == jax_sm.pick_q8_l_tile(d), d
