"""Encoder towers for inference, one branch or two at once (kernels 2 and 3),
and the video towers' int8 epilogue.

Replaces dldkd_tpu/ops/pallas/query_tower.py: `_dual_query_tower_kernel`
and `_dual_context_tower_kernel`, and through the one-branch launch
`_query_tower_kernel` and `_context_tower_kernel`; with `emit_q8=True` the
video towers end in `quantize_frames_q8` (the epilogue `_quantize_q8` /
`_map_context(emit_q8=True)`), which also builds the two-stage serving
index from stored frames. The CUDA sources are `csrc/tower.cu` (the f32
chain; LayerNorm, pooling and the int8 epilogue in both dtypes) and
`csrc/tower_mma.cu` (the bf16 towers' normalization, products and
attention on the tensor cores); their headers say what bounds the towers on
an H100 and how the chain of kernels answers that.

Weight tuples are in the JAX layout (Dense kernels (in, out)), as
`weights_for_branch` / `context_weights_for_branch` return them:
  query:  (wp, bp, pos, g1, b1, wq, bq, wk, bk, wv, bv, wo, bo, g2, b2, wm)
  video:  the same 15, then (wm, bm) of out_mapping_linear
with the input LayerNorm's affine folded into (wp, bp).

The kernels read the weights as `pack_weights` lays them out, which the
eval and the serving `Retriever` do once (`fast_eval.tower_weights`), not
once per launch.

The entry points pad and mask the inputs like the Pallas wrappers (query
tokens to a multiple of 8, positions past the learned table forced to
padding), then run the CUDA kernels for a CUDA tensor, or the plain
PyTorch version (`tower_plain`, on the weight tuples) for a CPU tensor.
The plain version rounds to the tower dtype at the Pallas kernel's points;
the CPU tests hold it against the Pallas kernels in interpret mode, and
`tower_packed_plain` (the plain version on the packed operands) against
it bitwise.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

# launches of the CUDA chains and of the int8 epilogue since the counts
# were last set to 0
LAUNCHES = {"query_tower": 0, "context_tower": 0, "context_tower_q8": 0}
# calls of pack_weights since the counts were last set to 0, by tower kind
PACKS = {"query": 0, "context": 0}

NEG_BIG = -10000.0   # the model's additive attention mask value
NEG_INF = -1e10      # pooling mask value (ops.masking.NEG_INF)
INT8_SCALE = 127.0   # symmetric quantization of cosine components

Weights = Tuple[torch.Tensor, ...]


# ---------------------------------------------------------------------- #
# weights
# ---------------------------------------------------------------------- #

def _encoder_weights(branch, tower: str, dtype: torch.dtype) -> Weights:
    # lazy: fast_eval imports this module
    from dldkd_tpu_torch.ops.fast_eval import _fold_input_proj

    wp, bp = _fold_input_proj(getattr(branch, f"{tower}_input_proj"), dtype)
    pe = getattr(branch, f"{tower}_pos_embed")
    enc = getattr(branch, f"{tower}_encoder")

    def t(p):
        return p.detach().float()

    return (wp, bp, t(pe.position_embeddings.weight), t(pe.LayerNorm.weight),
            t(pe.LayerNorm.bias),
            t(enc.self.query.weight).T, t(enc.self.query.bias),
            t(enc.self.key.weight).T, t(enc.self.key.bias),
            t(enc.self.value.weight).T, t(enc.self.value.bias),
            t(enc.output.dense.weight).T, t(enc.output.dense.bias),
            t(enc.output.LayerNorm.weight), t(enc.output.LayerNorm.bias))


def _branch(model, name: str):
    return model.branches[model.branch_names.index(name)]


def weights_for_branch(model, branch: str, dtype: torch.dtype) -> Weights:
    """Query-tower weight tuple of one branch of a DLDKD module."""
    br = _branch(model, branch)
    return (*_encoder_weights(br, "query", dtype),
            br.modular_vector_mapping.weight.detach().float().T)


def context_weights_for_branch(model, branch: str, dtype: torch.dtype
                               ) -> Weights:
    """Video-tower weight tuple of one branch of a DLDKD module."""
    br = _branch(model, branch)
    om = br.out_mapping_linear
    return (*_encoder_weights(br, "visual", dtype),
            om.weight.detach().float().T, om.bias.detach().float())


# ---------------------------------------------------------------------- #
# plain PyTorch version (the kernels' reference; the CPU path)
# ---------------------------------------------------------------------- #

def _rt(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round to the tower dtype and widen back to f32."""
    return x.to(dtype).float()


def _mat(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A weight matrix rounded to the tower dtype, widened, in standard
    strides: a product's operands are then the same tensors whatever layout
    the weights came in, so its CPU result is too."""
    return _rt(w, dtype).clone(memory_format=torch.contiguous_format)


def _ln(x: torch.Tensor, scale, bias, dtype) -> torch.Tensor:
    """LayerNorm over the last axis, f32 statistics (E[x^2] - mu^2)."""
    mu = x.mean(-1, keepdim=True)
    var = (x * x).mean(-1, keepdim=True) - mu * mu
    xn = (x - mu) * torch.rsqrt(var + 1e-5)
    return _rt(xn * scale.float() + bias.float(), dtype)


def input_norm_plain(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Affine-free input LayerNorm of x rounded to the tower dtype; the
    result is rounded to the tower dtype (held as f32)."""
    xf = _rt(x, dtype)
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    return _rt((xf - mu) * torch.rsqrt(var + 1e-5), dtype)


def trunk_plain(xn: torch.Tensor, mask: torch.Tensor, w: Weights,
                n_heads: int, dtype: torch.dtype) -> torch.Tensor:
    """Folded projection + ReLU, positions + LN, MHA, residual LN, on the
    normalized input (N, L, D) -> (N, L, H) (tower-dtype values, f32)."""
    (wp, bp, pos, g1, b1, wq, bq, wk, bk, wv, bv, wo, bo, g2, b2) = w[:15]
    n, l, _ = xn.shape
    hdim = wp.shape[1]
    d_head = hdim // n_heads
    h = _rt(torch.relu(xn @ _mat(wp, dtype) + _rt(bp, dtype)), dtype)
    h = _rt(h + _rt(pos, dtype)[None], dtype)
    h2 = _ln(h, g1, b1, dtype)

    def dense(wt, bt):
        return _rt(h2 @ _mat(wt, dtype) + bt.float(), dtype)

    def heads(y):
        return y.reshape(n, l, n_heads, d_head).transpose(1, 2)

    q, k, v = heads(dense(wq, bq)), heads(dense(wk, bk)), heads(dense(wv, bv))
    s = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(d_head))
    s = s + ((1.0 - mask) * NEG_BIG)[:, None, None, :]
    p = _rt(torch.softmax(s, dim=-1), dtype)
    ctx = _rt((p @ v).transpose(1, 2).reshape(n, l, hdim), dtype)
    out = _rt(_rt(ctx @ _mat(wo, dtype) + bo.float(), dtype) + h2, dtype)
    return _ln(out, g2, b2, dtype)


def pool_plain(out: torch.Tensor, mask: torch.Tensor, wm: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """Modular pooling: (N, L, H) -> (N, H) f32."""
    att = (out @ _mat(wm, dtype)).squeeze(-1)
    att = torch.where(mask > 0, att, torch.full_like(att, NEG_INF))
    att = torch.softmax(att, dim=-1)
    return (out * att[..., None]).sum(dim=1)


def quantize_unit_int8(x: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 of values in [-1, 1]: round(x * 127) (half to even),
    saturating at +-127."""
    return torch.clamp(torch.round(x.float() * INT8_SCALE), -INT8_SCALE,
                       INT8_SCALE).to(torch.int8)


def _warp_order_sum(sq: torch.Tensor) -> torch.Tensor:
    """f32 sum over the last axis in the order of the CUDA epilogue's warp:
    lane l adds elements l, l + 32, ... in turn, then the lanes combine in
    a butterfly (16, 8, 4, 2, 1 apart). Keeps the last axis (size 1)."""
    h = sq.shape[-1]
    hp = -(-h // 32) * 32
    rows = F.pad(sq, (0, hp - h)).reshape(*sq.shape[:-1], hp // 32, 32)
    acc = rows[..., 0, :]
    for k in range(1, hp // 32):
        acc = acc + rows[..., k, :]
    width = 32
    while width > 1:
        width //= 2
        acc = acc[..., :width] + acc[..., width:2 * width]
    return acc


def quantize_frames_q8_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the int8 epilogue: per-row L2 normalization in x's
    own dtype (f32 or bf16), then `quantize_unit_int8`. The rounding points
    are those of `ops.masking.l2_normalize` and of the TPU epilogue
    (dldkd_tpu/ops/pallas/query_tower.py:158-165): the product x * x in
    x's dtype, its f32 sum rounded back, the square root and the divide
    each rounded to x's dtype. Only the order of the f32 sum is the
    kernel's own (`_warp_order_sum`), so kernel and plain version agree
    bitwise."""
    dt = x.dtype
    sq = (x * x).float()                                   # rounded to dt
    s = _warp_order_sum(sq).to(dt).float()                 # sum rounded
    norm = torch.sqrt(s).to(dt).float()                    # sqrt rounded
    xn = (x.float() / torch.clamp(norm, min=1e-12)).to(dt)  # divide rounded
    return quantize_unit_int8(xn)


def quantize_frames_q8(x: torch.Tensor, plain: bool = False
                       ) -> torch.Tensor:
    """int8 frames (..., H) from frame features (..., H) in f32 or bf16:
    per-frame L2 normalization, then symmetric int8 (the canonical
    `quantize_frames_q8` of dldkd_tpu/ops/pallas/sim_max.py:235). On a CUDA
    tensor it launches the epilogue kernel of csrc/tower.cu; on a CPU
    tensor, or with plain=True, it runs `quantize_frames_q8_plain`."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"quantize_frames_q8: want f32 or bf16, got "
                         f"{x.dtype}")
    if plain or x.device.type == "cpu":
        return quantize_frames_q8_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_frames_q8: unsupported device {x.device}")
    x = x.contiguous()
    y = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        _launch_quantize(x, y, torch.cuda.current_stream().cuda_stream)
    return y


def _launch_quantize(x: torch.Tensor, y: torch.Tensor, stream) -> None:
    """The epilogue kernel on contiguous x (..., H) in the tower dtype into
    int8 y of the same shape; counts one launch."""
    from dldkd_tpu_torch.ops.kernels.build import bind, check

    h = x.shape[-1]
    check(bind("tower", "tower_quantize_q8", 2, 3)(
        x.data_ptr(), y.data_ptr(), x.numel() // max(h, 1), h,
        int(x.dtype == torch.bfloat16), stream), "tower_quantize_q8")
    LAUNCHES["context_tower_q8"] += 1


def tower_plain(x: torch.Tensor, mask: torch.Tensor,
                weights: Sequence[Weights], n_heads: int, dtype: torch.dtype,
                kind: str, emit_q8: bool = False) -> List[torch.Tensor]:
    """Plain version of one launch over len(weights) branches, on inputs
    already padded and masked by the entry points. Query outputs are
    (N, H) f32, video outputs (N, L, H) in the tower dtype, or int8 with
    emit_q8."""
    xn = input_norm_plain(x, dtype)
    outs = []
    for w in weights:
        out = trunk_plain(xn, mask, w, n_heads, dtype)
        if kind == "query":
            outs.append(pool_plain(out, mask, w[15], dtype))
        else:
            y = (out @ _mat(w[15], dtype) + w[16].float()).to(dtype)
            outs.append(quantize_frames_q8_plain(y) if emit_q8 else y)
    return outs


# ---------------------------------------------------------------------- #
# CUDA chain
# ---------------------------------------------------------------------- #

def pack_weights(weights: Sequence[Weights], dtype: torch.dtype,
                 device=None) -> Dict[str, torch.Tensor]:
    """The kernel chains' operands for one launch over the G = len(weights)
    branches of one hidden size H, in the layout the kernels read; made
    once per eval or Retriever model (fast_eval.tower_weights). Matrices
    are in the tower dtype, the rest f32 (holding tower-dtype values where
    the Pallas kernel casts them). Each product's weight is (K, N) for the
    f32 SIMT product and transposed, (N, K) K-major, for the bf16 tensor
    cores:
      wp    the folded projections side by side (one read of the raw input
            for all branches): (D, G H) or (G H, D); bp (G H)
      pos   every branch's whole positional table side by side, zero rows
            past a shorter one: (P, G H); a launch adds its first rows
      g1, b1, g2, b2, bo   (G, H)
      wqkv  Q|K|V per branch: (G, H, 3H) or (G, 3H, H); bqkv (G, 3H)
      wo    (G, H, H)
      query: wm (G, H), the pooling vectors;
      video: wm (G, H, H) and bm (G, H), out_mapping_linear."""
    kind = "query" if len(weights[0]) == 16 else "context"
    PACKS[kind] += 1
    f32 = torch.float32
    kmajor = dtype == torch.bfloat16

    def mat(w):
        w = w.to(device=device, dtype=dtype)
        return w.T if kmajor else w

    def vec(i, cast):
        return torch.stack([w[i].to(device=device, dtype=cast)
                            for w in weights]).contiguous()

    def mats(ws):
        return torch.stack([mat(w) for w in ws]).contiguous()

    n_pos = max(w[2].shape[0] for w in weights)
    packed = {
        "wp": torch.cat([mat(w[0]) for w in weights],
                        dim=0 if kmajor else 1).contiguous(),
        "bp": torch.cat([w[1].to(device=device, dtype=dtype)
                         for w in weights]).float(),
        "pos": torch.cat([F.pad(w[2].to(device=device, dtype=dtype),
                                (0, 0, 0, n_pos - w[2].shape[0]))
                          for w in weights], dim=1).float().contiguous(),
        "g1": vec(3, f32), "b1": vec(4, f32),
        "wqkv": mats([torch.cat([w[5], w[7], w[9]], 1) for w in weights]),
        "bqkv": torch.stack([torch.cat([w[6], w[8], w[10]]).to(
            device=device, dtype=f32) for w in weights]).contiguous(),
        "wo": mats([w[11] for w in weights]), "bo": vec(12, f32),
        "g2": vec(13, f32), "b2": vec(14, f32),
    }
    if kind == "query":
        packed["wm"] = torch.stack([w[15].reshape(-1).to(device=device,
                                                          dtype=dtype)
                                    for w in weights]).float().contiguous()
    else:
        packed["wm"], packed["bm"] = mats([w[15] for w in weights]), \
            vec(16, f32)
    return packed


def _pos_rows(packed, l: int, pos_rows=None) -> int:
    """Rows of each sequence that get a positional row: the first l (or
    pos_rows), at most the packed table's."""
    return min(l if pos_rows is None else pos_rows, packed["pos"].shape[0])


def unpack_weights(packed: Dict[str, torch.Tensor], dtype: torch.dtype,
                   l: int, pos_rows=None) -> List[Weights]:
    """Each branch's weight tuple read back from the packed operands, in the
    JAX layout, with the positions of a launch over sequences of l rows
    (the table's first `_pos_rows` rows, zeros after)."""
    g_n, _, hdim = packed["wo"].shape
    kmajor = dtype == torch.bfloat16

    def kn(w):  # a product's weight back to (K, N)
        return w.T if kmajor else w

    rows = _pos_rows(packed, l, pos_rows)
    pos = F.pad(packed["pos"][:rows], (0, 0, 0, l - rows))
    wp = kn(packed["wp"])
    out = []
    for b in range(g_n):
        c = slice(b * hdim, (b + 1) * hdim)
        wqkv, bqkv = kn(packed["wqkv"][b]), packed["bqkv"][b]
        q, k, v = (slice(i * hdim, (i + 1) * hdim) for i in range(3))
        w = (wp[:, c], packed["bp"][c], pos[:, c], packed["g1"][b],
             packed["b1"][b], wqkv[:, q], bqkv[q], wqkv[:, k], bqkv[k],
             wqkv[:, v], bqkv[v], kn(packed["wo"][b]), packed["bo"][b],
             packed["g2"][b], packed["b2"][b])
        if "bm" in packed:
            w += (kn(packed["wm"][b]), packed["bm"][b])
        else:
            w += (packed["wm"][b].reshape(-1, 1),)
        out.append(w)
    return out


def tower_packed_plain(x: torch.Tensor, mask: torch.Tensor,
                       packed: Dict[str, torch.Tensor], n_heads: int,
                       dtype: torch.dtype, kind: str, emit_q8: bool = False,
                       pos_rows=None) -> List[torch.Tensor]:
    """The plain version on the packed operands (`pack_weights`), with the
    positions the kernels add (`pos_rows` as in tower_cuda): equal to
    tower_plain on the weight tuples, bitwise, when the packed layout
    carries every branch's weights."""
    return tower_plain(x, mask, unpack_weights(packed, dtype, x.shape[1],
                                               pos_rows),
                       n_heads, dtype, kind, emit_q8)


def check_mma_shapes(d: int, hdim: int, n_heads: int, l: int,
                     what: str) -> None:
    """Raise on what the bf16 tensor-core chain does not take: 16-byte
    rows for cp.async (input width and hidden size multiples of 8),
    sequences of at most 128, heads of at most 128 dims."""
    if d % 8 or hdim % 8:
        raise ValueError(f"{what}: the bf16 tower kernels need the input "
                         f"width ({d}) and hidden size ({hdim}) to be "
                         f"multiples of 8")
    if l > 128 or hdim % n_heads or hdim // n_heads > 128:
        raise ValueError(f"{what}: the bf16 attention kernel takes at most "
                         f"128 rows and 128 dims per head, got L = {l}, "
                         f"H = {hdim}, {n_heads} heads")


def tower_cuda(x: torch.Tensor, mask: torch.Tensor,
               packed: Dict[str, torch.Tensor], n_heads: int,
               dtype: torch.dtype, kind: str, emit_q8: bool = False,
               pos_rows=None) -> List[torch.Tensor]:
    """The CUDA chain for one launch over the branches in `packed`
    (pack_weights, in `dtype`'s layout); same contract as tower_plain. x
    and mask are contiguous f32 CUDA tensors; each sequence's first
    `pos_rows` rows (default: all) get positional rows. bf16: the input
    normalization, products (wgmma) and attention (mma.sync) of
    csrc/tower_mma.cu; f32: csrc/tower.cu's SIMT chain; both: tower.cu's
    LayerNorm, pooling and int8 epilogue. With emit_q8 (video towers) the
    out_mapping product goes to a scratch buffer and the int8 epilogue
    writes the outputs."""
    from dldkd_tpu_torch.ops.kernels.build import bind, check

    g_n, _, hdim = packed["wo"].shape
    n, l, d = x.shape
    m = n * l
    gh = g_n * hdim
    bf = dtype == torch.bfloat16
    if bf:
        check_mma_shapes(d, hdim, n_heads, l, "tower_cuda")
    rows = _pos_rows(packed, l, pos_rows)
    dev = x.device
    f32 = torch.float32
    p = {k: v.data_ptr() for k, v in packed.items()}

    layernorm = bind("tower", "tower_layernorm", 4, 5)
    mma = bind("tower_mma", "tower_gemm_mma", 6, 17) if bf else None
    simt = None if bf else bind("tower", "tower_gemm", 8, 17)

    # Each buffer is made when its kernel writes it and dropped after its
    # last reader, so the launch's peak holds only the live ones (at 200
    # videos: the qkv product, its input and attention's output). Every
    # kernel runs on the current stream, which orders a block's reuse.
    def new(*shape):
        return torch.empty(shape, dtype=dtype, device=dev)

    with torch.cuda.device(dev):
        s = torch.cuda.current_stream().cuda_stream

        def gemm(what, a, w, bias, c, res, dims, strides, relu=0,
                 batch=g_n, pos=None, stats=(None, None)):
            """dims (M, N, K, lda, ldw, ldc, ldp, ldr), strides (sa, sw,
            sb, sc, sr); ldw is of the dtype's layout"""
            if bf:
                rc = mma(a, w, bias, c, pos, res, *dims, *strides, relu, l,
                         rows, batch, s)
            else:
                rc = simt(a, w, bias, c, *stats, pos, res, *dims, *strides,
                          relu, l, rows, batch, s)
            check(rc, f"tower_gemm ({what})")

        if bf:
            a = new(m, d)
            check(bind("tower_mma", "tower_normalize", 2, 2)(
                x.data_ptr(), a.data_ptr(), m, d, s), "tower_normalize")
            stats = (None, None)
        else:
            a = x
            mu = torch.empty(m, dtype=f32, device=dev)
            rstd = torch.empty(m, dtype=f32, device=dev)
            check(bind("tower", "tower_row_stats", 3, 2)(
                x.data_ptr(), mu.data_ptr(), rstd.data_ptr(), m, d, s),
                "tower_row_stats")
            stats = (mu.data_ptr(), rstd.data_ptr())
        # folded projection over every branch's columns: one read of x
        h = new(m, gh)
        gemm("projection", a.data_ptr(), p["wp"], p["bp"], h.data_ptr(),
             None, (m, gh, d, d, d if bf else gh, gh, gh, gh),
             (0, 0, 0, 0, 0), relu=1, batch=1, pos=p["pos"], stats=stats)
        del a
        h2 = new(m, gh)
        check(layernorm(h.data_ptr(), h2.data_ptr(), p["g1"], p["b1"],
                        m, g_n, hdim, gh, int(bf), s),
              "tower_layernorm (positions)")
        del h
        qkv = new(g_n, m, 3 * hdim)
        gemm("qkv", h2.data_ptr(), p["wqkv"], p["bqkv"], qkv.data_ptr(),
             None, (m, 3 * hdim, hdim, gh, hdim if bf else 3 * hdim,
                    3 * hdim, 3 * hdim, 0),
             (hdim, hdim * 3 * hdim, 3 * hdim, m * 3 * hdim, 0))
        attention = (bind("tower_mma", "tower_attention_mma", 3, 5, 1) if bf
                     else bind("tower", "tower_attention", 3, 5, 1))
        ctx = new(g_n, m, hdim)
        check(attention(qkv.data_ptr(), mask.data_ptr(), ctx.data_ptr(), g_n,
                        n, l, hdim, n_heads, 1.0 / math.sqrt(hdim // n_heads),
                        s), "tower_attention")
        del qkv
        o = new(m, gh)
        gemm("output", ctx.data_ptr(), p["wo"], p["bo"], o.data_ptr(),
             h2.data_ptr(), (m, hdim, hdim, hdim, hdim, gh, 0, gh),
             (m * hdim, hdim * hdim, hdim, hdim, hdim))
        del ctx, h2
        out = new(m, gh)
        check(layernorm(o.data_ptr(), out.data_ptr(), p["g2"], p["b2"],
                        m, g_n, hdim, gh, int(bf), s),
              "tower_layernorm (output)")
        del o
        if kind == "query":
            pooled = torch.empty((g_n, n, hdim), dtype=f32, device=dev)
            check(bind("tower", "tower_pool", 4, 6)(
                out.data_ptr(), mask.data_ptr(), p["wm"], pooled.data_ptr(),
                g_n, n, l, hdim, gh, int(bf), s), "tower_pool")
            LAUNCHES["query_tower"] += 1
            return list(pooled.unbind(0))
        y = new(g_n, m, hdim)
        gemm("out_mapping", out.data_ptr(), p["wm"], p["bm"], y.data_ptr(),
             None, (m, hdim, hdim, gh, hdim, hdim, 0, 0),
             (hdim, hdim * hdim, hdim, m * hdim, 0))
        if emit_q8:
            y8 = torch.empty((g_n, m, hdim), dtype=torch.int8, device=dev)
            _launch_quantize(y, y8, s)
            y = y8
    LAUNCHES["context_tower"] += 1
    return [t.view(n, l, hdim) for t in y.unbind(0)]


# ---------------------------------------------------------------------- #
# entry points
# ---------------------------------------------------------------------- #

def _check_inputs(x, mask, weights, dtype, what):
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: the tower dtype must be f32 or bf16, got "
                         f"{dtype}")
    if x.dim() != 3 or mask.dim() != 2 or tuple(mask.shape) != tuple(
            x.shape[:2]):
        raise ValueError(f"{what}: want x (N, L, D) and mask (N, L); got "
                         f"{tuple(x.shape)} and {tuple(mask.shape)}")
    if x.dtype != torch.float32 or mask.dtype != torch.float32:
        raise ValueError(f"{what}: x and mask must be f32, got {x.dtype} "
                         f"and {mask.dtype}")
    if x.device != mask.device:
        raise ValueError(f"{what}: x on {x.device}, mask on {mask.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    hs = {w[0].shape[1] for w in weights}
    if len(hs) != 1:
        raise ValueError(f"{what}: one launch needs one hidden size, got "
                         f"{sorted(hs)}")
    for w in weights:
        if w[0].shape[0] != x.shape[2]:
            raise ValueError(f"{what}: input width {x.shape[2]} vs weights "
                             f"{w[0].shape[0]}")


def _check_pos_table(pos, l: int, what: str, grid_allowance: bool = False):
    """A sequence longer than the positional table is an error, except for
    the query towers' 8-token grid (those tail positions get zero
    embeddings and are forced to padding)."""
    limit = -(-pos.shape[0] // 8) * 8 if grid_allowance else pos.shape[0]
    if l > limit:
        raise ValueError(
            f"{what}: sequence length {l} exceeds the learned positional "
            f"table ({pos.shape[0]}) — the model would fail here too")


def _with_pos(w: Weights, l: int, l_p: int) -> Weights:
    pos = w[2][:l]
    pos = F.pad(pos, (0, 0, 0, l_p - pos.shape[0]))
    return (*w[:2], pos, *w[3:])


def _run(x, mask, weights, n_heads, dtype, kind, l, plain, emit_q8=False,
         packed=None):
    """One launch over sequences of l rows (x padded past them): the plain
    version on the weight tuples on the CPU or with plain=True, else the
    CUDA chain on the packed operands (packed here when not given)."""
    if plain or x.device.type == "cpu":
        weights = [_with_pos(w, l, x.shape[1]) for w in weights]
        return tower_plain(x, mask, weights, n_heads, dtype, kind, emit_q8)
    if packed is None:
        packed = pack_weights(weights, dtype, x.device)
    return tower_cuda(x.contiguous(), mask.contiguous(), packed, n_heads,
                      dtype, kind, emit_q8, pos_rows=l)


def query_towers(x: torch.Tensor, mask: torch.Tensor,
                 weights: Sequence[Weights], n_heads: int,
                 dtype: torch.dtype, n_pos: int, what: str,
                 plain: bool = False, packed=None) -> List[torch.Tensor]:
    """Pooled (Nq, H) f32 vectors for each weight tuple, in one launch.
    Tokens pad to a multiple of 8; positions at or past `n_pos` are
    padding (dldkd_tpu/ops/pallas/query_tower.py:264-286). packed: the
    weights' `pack_weights` operands, if already made."""
    _check_inputs(x, mask, weights, dtype, what)
    nq, lq, _ = x.shape
    lq_p = -(-lq // 8) * 8
    for w in weights:
        _check_pos_table(w[2], lq, what, grid_allowance=True)
    x = F.pad(x, (0, 0, 0, lq_p - lq))
    keep = min(lq, n_pos)  # tokens from n_pos on are padding
    mask = F.pad(mask[:, :keep], (0, lq_p - keep))
    return _run(x, mask, weights, n_heads, dtype, "query", lq, plain,
                packed=packed)


def context_towers(x: torch.Tensor, mask: torch.Tensor,
                   weights: Sequence[Weights], n_heads: int,
                   dtype: torch.dtype, what: str,
                   plain: bool = False, emit_q8: bool = False,
                   packed=None) -> List[torch.Tensor]:
    """Frame features (Nv, L, H) in the tower dtype for each weight tuple,
    in one launch; with emit_q8 the int8 index rows (Nv, L, H) instead
    (`quantize_frames_q8` of those frame features). packed: as for
    query_towers."""
    _check_inputs(x, mask, weights, dtype, what)
    lv = x.shape[1]
    for w in weights:
        _check_pos_table(w[2], lv, what)
    return _run(x, mask, weights, n_heads, dtype, "context", lv, plain,
                emit_q8, packed)


def fused_query_tower(x, mask, weights: Weights, n_heads: int,
                      dtype: torch.dtype = torch.bfloat16,
                      n_pos_cap: int = 0, plain: bool = False
                      ) -> torch.Tensor:
    """One branch's pooled query vectors (Nq, H) f32. n_pos_cap: treat
    positions from this many on as padding (0 = the branch's own table);
    multi-branch callers pass the smallest table across branches."""
    n_pos = weights[2].shape[0]
    if n_pos_cap:
        n_pos = min(n_pos, n_pos_cap)
    return query_towers(x, mask, [weights], n_heads, dtype, n_pos,
                        "fused_query_tower", plain)[0]


def fused_query_tower_dual(x, mask, weights_a: Weights, weights_b: Weights,
                           n_heads: int, dtype: torch.dtype = torch.bfloat16,
                           plain: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both branches' pooled query vectors from one read of the input."""
    n_pos = min(weights_a[2].shape[0], weights_b[2].shape[0])
    a, b = query_towers(x, mask, [weights_a, weights_b], n_heads, dtype,
                        n_pos, "fused_query_tower_dual", plain)
    return a, b


def fused_context_tower(x, mask, weights: Weights, n_heads: int,
                        dtype: torch.dtype = torch.bfloat16,
                        plain: bool = False,
                        emit_q8: bool = False) -> torch.Tensor:
    """One branch's frame features (Nv, L, H) in the tower dtype, or its
    int8 index rows with emit_q8."""
    return context_towers(x, mask, [weights], n_heads, dtype,
                          "fused_context_tower", plain, emit_q8)[0]


def fused_context_tower_dual(x, mask, weights_a: Weights, weights_b: Weights,
                             n_heads: int,
                             dtype: torch.dtype = torch.bfloat16,
                             plain: bool = False, emit_q8: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both branches' frame features (or int8 index rows, emit_q8) from
    one read of the raw frames."""
    a, b = context_towers(x, mask, [weights_a, weights_b], n_heads, dtype,
                          "fused_context_tower_dual", plain, emit_q8)
    return a, b
