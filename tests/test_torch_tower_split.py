"""The towers' tensor-core chain on the CPU: its split arithmetic, its key
tiles and its padded widths, held against the plain version and the JAX
package.

The CUDA chain (csrc/tower_mma.cu, csrc/tower.cu) runs only on the card.
Here a torch emulation of its arithmetic on the packed operands
(`query_tower.pack_weights`: K-major weights, every width padded to a
multiple of 8) follows the chain kernel by kernel: the products in 3xTF32
(each operand split into TF32 big and small parts, `sim_max.split_tf32`,
as the kernel splits a stage in shared memory; small.big + big.small +
big.big, each an f32 matmul of TF32 values, so exact products; small as
the tensor core reads it) or bf16, the attention in key tiles of the
kernel's size (bf16: one pass for one tile, else the rows' max and sum
over all tiles first, then p = round(e / sum) and P V; f32: 32-key tiles
and an online softmax, P V of e rescaled as the max grows, divided by the
sum at the end), the epilogues at the kernel's rounding points.

- f32: the emulation within 1e-4 of `tower_plain` (IEEE f32 products) and
  of the Pallas towers in interpret mode at "highest" precision
  (`encode_*_best(prefer_pallas=True, interpret=True)`, as
  tests/test_torch_towers.py runs them, compiled once with jax.jit), both
  tower kinds, the two-branch and the one-branch launch: the card's f32
  tower tolerance (tests/test_torch_cuda.py; five chained products, each
  within ~2^-22 of the f32 product, sums in another order).
- bf16 at L = 136 (two key tiles): the emulation within the card's bf16
  tower tolerance, 3e-2, of `tower_plain` (the same rounding points; an
  f32 sum in another order flips a bf16 rounding now and then).
- The shapes the kernels used to refuse (L = 136 and 300, input width 44
  with hidden 36 and 4 heads of 9 dims, hidden 256 with 1 head), in f32
  and bf16, on weights drawn as the model initializes them: the port's
  plain path against the JAX package's XLA path (`encode_context_fast`,
  `encode_query_fast`: what JAX runs for these shapes off the TPU), within
  5e-5 in f32 (F32_FRAME_TOL of tests/test_torch_towers.py: same
  operations, other sum orders) and 3e-2 in bf16 (the card's bf16 tower
  tolerance: the XLA path rounds its attention scores, softmax and
  products to bf16 at other points than the Pallas kernel whose rounding
  the port keeps, a few bf16 ulps of the O(1) outputs); and
  `tower_packed_plain` on the padded operands bitwise equal to
  `tower_plain`. Every query has a valid token: a query with none attends
  uniformly over every key, and the port, like the Pallas wrapper, pads
  queries to the 8-token grid where the XLA path does not.

The JAX parameters are made with numpy from a seed on the shapes
`jax.eval_shape` gives, and each JAX function is compiled once per shape
(`jax.jit`): the file runs in about 25 s on one CPU core.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dldkd_tpu.config import ModelConfig as JaxModelConfig
from dldkd_tpu.models import DLDKD as JaxDLDKD
from dldkd_tpu.ops import fast_eval as jax_fast
from dldkd_tpu_torch.config import ModelConfig
from dldkd_tpu_torch.convert import load_jax_params
from dldkd_tpu_torch.models import DLDKD
from dldkd_tpu_torch.ops import fast_eval
from dldkd_tpu_torch.ops.kernels import query_tower as qt
from dldkd_tpu_torch.ops.kernels.sim_max import split_tf32

TOWER_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
F32_FRAME_TOL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_numerics():
    threads = torch.get_num_threads()
    precision = torch.get_float32_matmul_precision()
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(threads)
    torch.set_float32_matmul_precision(precision)


# ------------------------------------------------ the chain's arithmetic

def _tf32_read(x):
    """What a tensor core reads of an f32 value: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm3(a, w):
    """a (..., K) times w (N, K)^T in 3xTF32 from the split parts:
    small.big + big.small + big.big, each product of TF32 values exact."""
    (ab, as_), (wb, ws) = split_tf32(a), split_tf32(w)
    return _tf32_read(as_) @ wb.mT + ab @ _tf32_read(ws).mT + ab @ wb.mT


def _key_tile(l, depth, f32):
    """The attention kernel's key tile (csrc/tower_mma.cu,
    attention_by_length)."""
    if l <= 32 or f32:
        return 32
    return 64 if depth > 128 else 128


def emulate_tower(x, mask, packed, n_heads, dtype, kind, pos_rows=None,
                  ln=None, pool=None):
    """The CUDA chain of `query_tower.tower_cuda` in torch on the packed
    operands, kernel by kernel, at the kernels' rounding points. ln(v,
    gamma, beta, hdim, rt) and pool(out (N, L, H), mask, wm (H,)) replace
    the LayerNorm and the pooling written here with torch's reductions
    (tests/test_torch_tower_fused.py passes the epilogue's sum orders)."""
    f32 = dtype == torch.float32
    hdim, _, d = (int(v) for v in packed["dims"])
    g_n, hp = packed["g1"].shape
    dh = hdim // n_heads
    dhp = -(-dh // 8) * 8
    hq, dp = n_heads * dhp, -(-d // 8) * 8
    n, l, _ = x.shape
    m = n * l

    def rt(v):
        return v if f32 else v.to(torch.bfloat16).float()

    def mm(a, w):
        return _mm3(a, w) if f32 else a @ w.float().mT

    def mmw(a, name, b=None):  # a product with a packed weight
        return mm(a, packed[name] if b is None else packed[name][b])

    def ln_mean(v, gamma, beta, hdim, rt):  # statistics over the true
        t = v[..., :hdim]                   # width, zero pad
        mu = t.mean(-1, keepdim=True)
        var = (t * t).mean(-1, keepdim=True) - mu * mu
        return rt((v - mu) * torch.rsqrt(var + 1e-5) * gamma + beta)

    def pool_softmax(out, mask, wm):
        att = torch.softmax(torch.where(mask > 0, out @ wm, torch.full(
            mask.shape, qt.NEG_INF)), dim=-1)
        return (out * att[..., None]).sum(1)

    ln = ln or ln_mean
    pool = pool or pool_softmax

    # 1. normalize, at the padded width
    xf = rt(x.reshape(m, d))
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    xn = torch.nn.functional.pad(rt((xf - mu) * torch.rsqrt(var + 1e-5)),
                                 (0, dp - d))
    # 2. projection, + positions on each sequence's first rows, LayerNorm
    h = rt(torch.relu(mmw(xn, "wp") + packed["bp"])).reshape(n, l, -1)
    rows = qt._pos_rows(packed, l, pos_rows)
    h[:, :rows] = rt(h[:, :rows] + packed["pos"][:rows])
    h = h.reshape(m, g_n, hp)
    outs = []
    for b in range(g_n):
        h2 = ln(h[:, b], packed["g1"][b], packed["b1"][b], hdim, rt)  # 2
        qkv = rt(mmw(h2, "wqkv", b) + packed["bqkv"][b])         # 3
        # 4. attention per head, key tiles of the kernel's size
        depth = dhp if f32 else -(-dhp // 16) * 16
        kt = _key_tile(l, depth, f32)
        bias = (1.0 - mask) * qt.NEG_BIG
        ctx = torch.zeros(n, l, hq)
        for hh in range(n_heads):
            q, k, v = (qkv[:, i * hq + hh * dhp:i * hq + (hh + 1) * dhp]
                       .reshape(n, l, dhp) for i in range(3))
            tiles = [slice(k0, min(l, k0 + kt)) for k0 in range(0, l, kt)]
            s = [mm(q, k[:, t]) * (1.0 / math.sqrt(dh)) + bias[:, None, t]
                 for t in tiles]
            mx = torch.full((n, l, 1), -math.inf)
            tot = torch.zeros(n, l, 1)
            o = torch.zeros(n, l, dhp)
            for t, st in zip(tiles, s):  # the rows' running max and sum
                mn = torch.maximum(mx, st.amax(-1, keepdim=True))
                alpha = torch.exp(mx - mn)
                e = torch.exp(st - mn)
                tot = tot * alpha + e.sum(-1, keepdim=True)
                if f32 and len(tiles) > 1:    # online: P V of e, rescaled
                    o = o * alpha + mm(e, v[:, t].transpose(1, 2))
                mx = mn
            if not (f32 and len(tiles) > 1):  # p = round(e / sum), P V
                for t, st in zip(tiles, s):
                    p = rt(torch.exp(st - mx) / tot)
                    o = o + mm(p, v[:, t].transpose(1, 2))
            else:
                o = o / tot
            ctx[..., hh * dhp:(hh + 1) * dhp] = o
        ctx = rt(ctx.reshape(m, hq))
        o = rt(rt(mmw(ctx, "wo", b) + packed["bo"][b]) + h2)     # 5
        out = ln(o, packed["g2"][b], packed["b2"][b], hdim, rt)
        if kind == "query":                             # 5: the pooling
            out = out.reshape(n, l, hp)[..., :hdim]
            outs.append(pool(out, mask, packed["wm"][b, :hdim]))
        else:                                                    # 6
            y = mmw(out, "wm", b) + packed["bm"][b]
            outs.append(y.reshape(n, l, hp)[..., :hdim].to(dtype))
    return outs


# ------------------------------------------------------------- models

_SMALL = dict(visual_input_size=64, query_input_size=48, inheritance_hidden=32,
              exploration_hidden=32, max_ctx_l=16, max_desc_l=12, n_heads=4)


@functools.lru_cache(maxsize=None)
def _params(dims: tuple, boost: bool):
    """The JAX model's parameters for these dims, made from a seed with
    numpy: with boost every leaf random normal x 0.5 (the LayerNorm
    affines and biases matter); else as the model initializes them
    (kernels and positional tables normal(0, initializer_range), biases 0,
    LayerNorm scales 1). Shapes from jax.eval_shape, without running the
    model's init."""
    cfg = JaxModelConfig(**dict(dims))
    video = jnp.zeros((1, cfg.max_ctx_l, cfg.visual_input_size))
    text = jnp.zeros((1, cfg.max_desc_l, cfg.query_input_size))
    shapes = jax.eval_shape(
        JaxDLDKD(config=cfg).init, jax.random.PRNGKey(0), video,
        jnp.ones(video.shape[:2]), text, jnp.ones(text.shape[:2]))
    rng = np.random.RandomState(7 if boost else 0)
    paths, tree = jax.tree_util.tree_flatten_with_path(shapes)

    def leaf(path, sd):
        name = str(getattr(path[-1], "key", path[-1]))
        if boost:
            x = rng.randn(*sd.shape) * 0.5
        elif name in ("kernel", "pos_embed"):
            x = rng.randn(*sd.shape) * cfg.initializer_range
        else:
            x = np.full(sd.shape, 1.0 if name == "scale" else 0.0)
        return jnp.asarray(x.astype(np.float32), sd.dtype)

    return jax.tree_util.tree_unflatten(tree, [leaf(p, sd)
                                               for p, sd in paths])


def _jax_models(dtype="float32", double=True, boost=True, **dims):
    """A JAX model, its parameters (`_params`) and the port's model loaded
    from them."""
    kw = dict(_SMALL, double_branch=double, **dims)
    params = _params(tuple(sorted(kw.items())), boost)
    kw["dtype"] = dtype
    jmodel = JaxDLDKD(config=JaxModelConfig(**kw))
    model = load_jax_params(DLDKD(ModelConfig(**kw)),
                            jax.tree.map(np.asarray, params)).eval()
    return jmodel, params, model


@functools.lru_cache(maxsize=None)
def _jit(fn, **kw):
    """fn(params, config, x, mask, **kw) compiled once per config and
    shape: one XLA program instead of op-by-op dispatch."""
    return jax.jit(functools.partial(fn, **kw), static_argnums=1)


def _inputs(n, l, d, seed, scale=1.0, all_masked=True):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, l, d) * scale).astype(np.float32)
    mask = np.ones((n, l), np.float32)
    mask[0, l // 3:] = 0.0
    if all_masked:
        mask[-1] = 0.0              # an all-masked (padding) row
    return x, mask


def _launch(model, kind, x, mask):
    """The eval's tower launch on the CPU: its packed operands, inputs
    padded and masked as the entry points do, the plain version's weight
    tuples."""
    tw = fast_eval.tower_weights(model)
    n_heads, dtype = model.config.n_heads, fast_eval.tower_dtype(model.config)
    l = x.shape[1]
    if kind == "query":
        n_pos = min(w[2].shape[0] for w in tw["query"])
        l_p = -(-l // 8) * 8
        x = torch.nn.functional.pad(x, (0, 0, 0, l_p - l))
        keep = min(l, n_pos)
        mask = torch.nn.functional.pad(mask[:, :keep], (0, l_p - keep))
    else:
        l_p = l
    ws = [qt._with_pos(w, l, l_p) for w in tw[kind]]
    return tw["packed"][kind][0], ws, x, mask, l, n_heads, dtype


@pytest.mark.parametrize("double", [True, False], ids=["dual", "single"])
@pytest.mark.parametrize("kind", ["query", "context"])
def test_f32_split_chain_matches_plain_and_pallas(kind, double):
    jmodel, params, model = _jax_models(double=double)
    d = _SMALL["query_input_size" if kind == "query" else "visual_input_size"]
    l = 12 if kind == "query" else 16
    # no all-masked row: its scores sit at -10000 + s, where an f32 ulp is
    # ~1e-3, so any two f32-grade orders of Q K^T differ there by a rounding
    # of the mask, which these weights (scores in the tens) carry into the
    # outputs at ~4e-4; the card's tests hold such rows at the model's
    # initial weights
    xa, ma = _inputs(9, l, d, seed=3, scale=3.0, all_masked=False)
    x, mask = torch.from_numpy(xa), torch.from_numpy(ma)
    packed, ws, xp, mp, rows, n_heads, dtype = _launch(model, kind, x, mask)
    got = emulate_tower(xp, mp, packed, n_heads, dtype, kind, pos_rows=rows)
    plain = qt.tower_plain(xp, mp, ws, n_heads, dtype, kind)
    fn = jax_fast.encode_query_best if kind == "query" \
        else jax_fast.encode_context_best
    pallas = _jit(fn, prefer_pallas=True, interpret=True)(
        params, jmodel.config, jnp.asarray(xa), jnp.asarray(ma))
    assert len(got) == (2 if double else 1)
    for g, p, want in zip(got, plain, pallas):
        assert g.shape == p.shape and bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), p.numpy(),
                                   atol=TOWER_TOL[torch.float32], rtol=0)
        np.testing.assert_allclose(g.numpy(), np.asarray(want),
                                   atol=TOWER_TOL[torch.float32], rtol=0)


@pytest.mark.parametrize("kind", ["query", "context"])
def test_f32_online_softmax_over_key_tiles_matches_plain(kind):
    """72 keys: f32 key tiles of 32, 32 and 8, each rescaling what the
    earlier ones gave, within the f32 tower tolerance of `tower_plain`."""
    cfg = ModelConfig(visual_input_size=40, query_input_size=40,
                      inheritance_hidden=32, exploration_hidden=32,
                      max_ctx_l=72, max_desc_l=72, n_heads=4,
                      double_branch=True, dtype="float32")
    model = DLDKD(cfg).init_weights(torch.Generator().manual_seed(6)).eval()
    xa, ma = _inputs(3, 72, 40, seed=8, scale=3.0, all_masked=False)
    packed, ws, xp, mp, rows, n_heads, dtype = _launch(
        model, kind, torch.from_numpy(xa), torch.from_numpy(ma))
    assert _key_tile(xp.shape[1], 8, True) == 32 < xp.shape[1]
    got = emulate_tower(xp, mp, packed, n_heads, dtype, kind, pos_rows=rows)
    plain = qt.tower_plain(xp, mp, ws, n_heads, dtype, kind)
    for g, p in zip(got, plain):
        assert g.shape == p.shape and bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), p.numpy(),
                                   atol=TOWER_TOL[torch.float32], rtol=0)


def test_split_products_carry_the_small_terms():
    """The emulated products with the small terms are f32-grade (within
    twice an IEEE f32 matmul's error of f64); the TF32 parts alone are not,
    so the 1e-4 above tests the split."""
    gen = torch.Generator().manual_seed(4)
    a = torch.randn(64, 200, generator=gen)
    w = torch.randn(48, 200, generator=gen)
    ref = (a.double() @ w.double().T)
    got = _mm3(a, w)
    big = split_tf32(a)[0] @ split_tf32(w)[0].T
    f32 = a @ w.T
    err = float((got.double() - ref).abs().max())
    err_f32 = float((f32.double() - ref).abs().max())
    err_big = float((big.double() - ref).abs().max())
    assert err <= 2 * err_f32 and err_big > 50 * err


@pytest.mark.parametrize("kind", ["query", "context"])
def test_tiled_bf16_attention_at_l_136_matches_plain(kind):
    """Two key tiles (128 + 8): the max and sum over both first, then p
    rounded to bf16 as the Pallas kernel casts it."""
    cfg = ModelConfig(visual_input_size=40, query_input_size=40,
                      inheritance_hidden=32, exploration_hidden=32,
                      max_ctx_l=136, max_desc_l=136, n_heads=4,
                      double_branch=True, dtype="bfloat16")
    model = DLDKD(cfg).init_weights(torch.Generator().manual_seed(2)).eval()
    xa, ma = _inputs(3, 136, 40, seed=5)
    packed, ws, xp, mp, rows, n_heads, dtype = _launch(
        model, kind, torch.from_numpy(xa), torch.from_numpy(ma))
    assert _key_tile(xp.shape[1], 16, False) == 128 < xp.shape[1]
    got = emulate_tower(xp, mp, packed, n_heads, dtype, kind, pos_rows=rows)
    plain = qt.tower_plain(xp, mp, ws, n_heads, dtype, kind)
    for g, p in zip(got, plain):
        assert g.dtype == p.dtype and bool(torch.isfinite(g.float()).all())
        np.testing.assert_allclose(g.float().numpy(), p.float().numpy(),
                                   atol=TOWER_TOL[torch.bfloat16], rtol=0)


# ------------------------------------- the shapes the kernels used to refuse

# (L, input width, hidden, heads): two and three key tiles, widths that are
# not multiples of 8 (4 heads of 9 dims), a 256-dim head
_SHAPES = [(136, 64, 32, 4), (300, 64, 32, 4), (20, 44, 36, 4),
           (20, 48, 256, 1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("l,d,hidden,heads", _SHAPES)
def test_plain_path_at_former_limits_matches_jax_xla(l, d, hidden, heads,
                                                     dtype):
    jmodel, params, model = _jax_models(
        dtype, boost=False, visual_input_size=d, query_input_size=d,
        inheritance_hidden=hidden, exploration_hidden=hidden, n_heads=heads,
        max_ctx_l=l, max_desc_l=l)
    xa, ma = _inputs(3, l, d, seed=l + d, all_masked=False)
    x, mask = torch.from_numpy(xa), torch.from_numpy(ma)
    for port, xla in ((fast_eval.encode_context_best,
                       jax_fast.encode_context_fast),
                      (fast_eval.encode_query_best,
                       jax_fast.encode_query_fast)):
        got = port(model, x, mask)
        want = _jit(xla)(params, jmodel.config, jnp.asarray(xa),
                         jnp.asarray(ma))
        for g, w in zip(got, want):
            g = g.float().numpy()
            w = np.asarray(jnp.asarray(w, jnp.float32))
            assert g.shape == w.shape and np.isfinite(g).all()
            tol = F32_FRAME_TOL if dtype == "float32" \
                else TOWER_TOL[torch.bfloat16]
            np.testing.assert_allclose(g, w, atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("l,d,hidden,heads", _SHAPES)
def test_packed_plain_at_former_limits_is_plain(l, d, hidden, heads, dtype):
    """The padded operands carry the weights exactly: the plain version on
    them equals it on the weight tuples, bitwise, for both towers."""
    cfg = ModelConfig(visual_input_size=d, query_input_size=d,
                      inheritance_hidden=hidden, exploration_hidden=hidden,
                      max_ctx_l=l, max_desc_l=l, n_heads=heads,
                      double_branch=True, dtype=dtype)
    model = DLDKD(cfg).init_weights(torch.Generator().manual_seed(1)).eval()
    xa, ma = _inputs(2, l, d, seed=d)
    for kind in ("query", "context"):
        packed, ws, xp, mp, rows, n_heads, tdt = _launch(
            model, kind, torch.from_numpy(xa), torch.from_numpy(ma))
        assert packed["wp"].shape[1] % 8 == 0
        assert packed["g1"].shape[1] % 8 == 0
        assert packed["wqkv"].shape[1] % (8 * 3 * heads) == 0
        want = qt.tower_plain(xp, mp, ws, n_heads, tdt, kind)
        got = qt.tower_packed_plain(xp, mp, packed, n_heads, tdt, kind,
                                    pos_rows=rows)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
