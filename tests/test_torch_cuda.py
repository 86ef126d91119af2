"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with the CUDA toolkit (sm_90a) and skip
elsewhere. This file imports nothing of JAX, so on a machine without JAX
run it without the suite's conftest (which configures JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: scores 1e-5 abs (IEEE f32 FMAs on both sides, bf16 widening
exactly; sums in another order); tower outputs 1e-4 abs in f32 (five chained
products, sums in another order) and 3e-2 abs in bf16 (the same rounding
points; another accumulation order flips a bf16 rounding now and then).
"""

import pytest
import torch

from dldkd_tpu_torch.config import ModelConfig
from dldkd_tpu_torch.models import DLDKD
from dldkd_tpu_torch.ops.fast_eval import tower_weights
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq,nv,l_frames,d", [(50, 2179, 128, 384),
                                              (7, 13, 5, 24),
                                              (65, 9, 17, 40)])
def test_sim_max_kernel_matches_plain(dev, dtype, nq, nv, l_frames, d):
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


def test_kernel_wrappers_reject_bad_inputs(dev):
    q = torch.randn(4, 8, device=dev)
    ctx = torch.randn(3, 5, 8, device=dev)
    mask = torch.ones(3, 5, device=dev)
    with pytest.raises(ValueError, match="several devices"):
        sim_max.fused_clip_scores(q, ctx, mask.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        sim_max.fused_clip_scores(q, ctx.transpose(0, 1).contiguous()
                                  .transpose(0, 1), mask)
