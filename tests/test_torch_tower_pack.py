"""The towers' packed operands (`query_tower.pack_weights`) on the CPU.

- The plain version read from the packed operands, in the layout the
  kernels read (every product's weight K-major, f32 ones as TF32 big and
  small planes, widths padded to multiples of 8, Q|K|V side by side,
  every branch's whole positional table with the rows past a launch's
  sequence cut by `pos_rows`), equals the plain version on the weight
  tuples bitwise, for both towers, one and two branches, f32 and bf16. The
  weight tuples are the JAX layout (tests/test_torch_towers.py holds them
  and the plain version against the JAX package), so the packed layout
  carries the JAX weights.
- The eval and the serving `Retriever` pack once per tower kind and launch
  group, not once per batch.
- Every shape the bf16 kernels once refused (sequences past 128 rows,
  widths that are not multiples of 8, heads past 128 dims) packs, with
  zero padding to multiples of 8, and computes what the weight tuples do.
"""

import numpy as np
import pytest
import torch

from dldkd_tpu_torch import evaluate, serving
from dldkd_tpu_torch.config import ModelConfig
from dldkd_tpu_torch.data.ingest import PackedQueries, PackedVideos
from dldkd_tpu_torch.models import DLDKD
from dldkd_tpu_torch.ops.fast_eval import tower_weights
from dldkd_tpu_torch.ops.kernels import query_tower as qt

# 12-row query table (9 tokens pad to 16: positions cut at 9), 20-row video
# table (16 frames: positions cut at 16)
_DIMS = dict(visual_input_size=64, query_input_size=48, inheritance_hidden=32,
             exploration_hidden=32, max_ctx_l=20, max_desc_l=12, n_heads=4)


def _model(dtype: str, double: bool = True, exploration_hidden: int = 32):
    cfg = ModelConfig(dtype=dtype, double_branch=double,
                      **{**_DIMS, "exploration_hidden": exploration_hidden})
    model = DLDKD(cfg).init_weights(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():     # LayerNorm affines and biases away from 1 / 0
        for p in model.parameters():
            p.add_(0.5 * torch.randn(p.shape, generator=gen))
    return model.eval()


def _inputs(n, l, d, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(n, l, d).astype(np.float32))
    mask = torch.from_numpy((rng.rand(n, l) > 0.3).astype(np.float32))
    mask[0] = 0.0                                  # an all-masked row
    return x, mask


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("branches", [2, 1])
@pytest.mark.parametrize("kind", ["query", "context"])
def test_packed_plain_equals_plain_bitwise(kind, branches, dtype):
    model = _model(dtype)
    tdt = getattr(torch, dtype)
    ws = tower_weights(model)[kind][:branches]
    if kind == "query":    # 9 tokens on the 8-token grid, 12-row table
        l, l_p, d = 9, 16, _DIMS["query_input_size"]
    else:                  # 16 frames, 20-row table
        l, l_p, d = 16, 16, _DIMS["visual_input_size"]
    x, mask = _inputs(7, l_p, d, seed=branches)
    packed = qt.pack_weights(ws, tdt, 4)
    g_h = branches * 32
    # the products' layouts: K-major for the tensor cores
    assert tuple(packed["wp"].shape) == (g_h, d)
    assert packed["wp"].dtype == packed["wqkv"].dtype == tdt
    assert tuple(packed["pos"].shape) == (ws[0][2].shape[0], g_h)
    for emit_q8 in ([False, True] if kind == "context" else [False]):
        want = qt.tower_plain(x, mask, [qt._with_pos(w, l, l_p) for w in ws],
                              4, tdt, kind, emit_q8)
        got = qt.tower_packed_plain(x, mask, packed, 4, tdt, kind, emit_q8,
                                    pos_rows=l)
        assert len(got) == branches
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    if kind == "query":  # the cut matters: rows 9-11 of the table count
        full = qt.tower_packed_plain(x, mask, packed, 4, tdt, kind)
        assert any(not torch.equal(a, b) for a, b in zip(full, want))


@pytest.mark.parametrize("double,expl", [(True, 32), (True, 16),
                                         (False, 32)],
                         ids=["dual", "unequal", "single"])
def test_tower_weights_pack_once_per_launch_group(double, expl):
    model = _model("float32", double, expl)
    ws = tower_weights(model)
    n_groups = 1 if (double and expl == 32) or not double else 2
    for kind in ("query", "context"):
        assert len(ws["packed"][kind]) == n_groups
        assert sum(p["wo"].shape[0] for p in ws["packed"][kind]) == len(
            ws[kind])


def _corpus(n_videos=11, n_queries=13, seed=3):
    rng = np.random.RandomState(seed)
    vf = rng.randn(n_videos, _DIMS["max_ctx_l"],
                   _DIMS["visual_input_size"]).astype(np.float32)
    vm = np.ones((n_videos, _DIMS["max_ctx_l"]), np.float32)
    vm[1, 7:] = 0.0
    ids = [f"v{i}" for i in range(n_videos)]
    qf = rng.randn(n_queries, _DIMS["max_desc_l"],
                   _DIMS["query_input_size"]).astype(np.float32)
    qm = np.ones((n_queries, _DIMS["max_desc_l"]), np.float32)
    qm[2, 4:] = 0.0
    q_vid = [ids[i % n_videos] for i in range(n_queries)]
    queries = PackedQueries(feats=qf, mask=qm,
                            cap_ids=[f"{v}#enc#{i}" for i, v in
                                     enumerate(q_vid)], video_ids=q_vid)
    return PackedVideos(feats=vf, mask=vm, ids=ids), queries


def _reset_packs():
    for k in qt.PACKS:
        qt.PACKS[k] = 0


@pytest.mark.parametrize("score_quant", [False, True])
def test_eval_packs_once_per_tower_kind(score_quant):
    """Several context and query batches, one pack per tower kind."""
    model = _model("bfloat16")
    videos, queries = _corpus()
    _reset_packs()
    scores = evaluate.score_matrices(model, videos, queries, context_bsz=4,
                                     query_bsz=5, device="cpu",
                                     score_quant=score_quant)
    assert qt.PACKS == {"query": 1, "context": 1}
    out = evaluate._metrics_from_score_matrices(
        *scores, evaluate._gt_on_device(queries, videos, "cpu"), (0.7, 0.3))
    assert all(np.isfinite(v) for m in out.values() for v in m.values())


@pytest.mark.parametrize("kw", [dict(), dict(score_quant=True)],
                         ids=["exact", "two_stage"])
def test_retriever_packs_once_per_model(kw):
    model = _model("bfloat16")
    videos, queries = _corpus()
    _reset_packs()
    r = serving.Retriever(model, query_bsz=4, device="cpu", **kw)
    r.index(videos, context_bsz=4)
    r.search(queries.feats, queries.mask, k=3)
    r.search(queries.feats[:5], queries.mask[:5], k=3)
    assert qt.PACKS == {"query": 1, "context": 1}


# (input width, hidden, heads, L, taken by the bf16 kernels before they
# padded widths and tiled the attention over keys)
@pytest.mark.parametrize("d,hdim,heads,l,ok", [
    (1024, 384, 4, 128, True), (768, 384, 4, 32, True), (40, 96, 4, 20, True),
    (44, 96, 4, 20, False), (40, 36, 4, 20, False), (40, 96, 4, 129, False),
    (40, 256, 1, 20, False)])
def test_bf16_kernel_shape_limits(d, hdim, heads, l, ok):
    """Each shape packs, every width padded to a multiple of 8 with zeros,
    and the plain version on the packed operands is the plain version on
    the weight tuples, bitwise, for both towers."""
    cfg = ModelConfig(visual_input_size=d, query_input_size=d,
                      inheritance_hidden=hdim, exploration_hidden=hdim,
                      max_ctx_l=l, max_desc_l=l, n_heads=heads,
                      double_branch=True, dtype="bfloat16")
    model = DLDKD(cfg).init_weights(torch.Generator().manual_seed(3)).eval()
    tw = tower_weights(model)
    x, mask = _inputs(2, l, d, seed=l)
    dh8 = -(-(hdim // heads) // 8) * 8
    for kind in ("query", "context"):
        packed = tw["packed"][kind][0]
        ws = [qt._with_pos(w, l, l) for w in tw[kind]]
        hp = packed["g1"].shape[1]
        assert hp % 8 == 0 and 0 <= hp - hdim < 8
        assert tuple(packed["wp"].shape) == (2 * hp, -(-d // 8) * 8)
        assert tuple(packed["wqkv"].shape) == (2, 3 * heads * dh8, hp)
        want = qt.tower_plain(x, mask, ws, heads, torch.bfloat16, kind)
        got = qt.tower_packed_plain(x, mask, packed, heads, torch.bfloat16,
                                    kind, pos_rows=l)
        assert (hp == hdim and dh8 == hdim // heads <= 128
                and d % 8 == 0 and l <= 128) == ok
        for g, w in zip(got, want):
            assert bool(torch.isfinite(g.float()).all())
            assert g.dtype == w.dtype and torch.equal(g, w)
