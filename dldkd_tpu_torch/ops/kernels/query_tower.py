"""Encoder towers for inference, one branch or two at once (kernels 2 and 3),
and the video towers' int8 epilogue.

Replaces dldkd_tpu/ops/pallas/query_tower.py: `_dual_query_tower_kernel`
and `_dual_context_tower_kernel`, and through the one-branch launch
`_query_tower_kernel` and `_context_tower_kernel`; with `emit_q8=True` the
video towers end in `quantize_frames_q8` (the epilogue `_quantize_q8` /
`_map_context(emit_q8=True)`), which also builds the two-stage serving
index from stored frames; with `q8_transposed=True` as well
(`fused_context_tower_dual`, `context_towers`) the epilogue writes the int8
rows padded and in the TPU scoring layout (L_p, Nv_p, H), as
`_map_context(transposed=True)` does. Both dtypes run one chain of CUDA kernels:
`csrc/tower_mma.cu` (the input normalization, every product on wgmma and
the attention on mma.sync, on the tensor cores: bf16 products in bf16,
f32 products in 3xTF32, the f32-grade split products of the f32 scorer;
the LayerNorms, and the query tower's pooling, in the epilogues of the
products that feed them) and `csrc/tower.cu` (the int8 epilogue). The
attention streams its keys in tiles, so every sequence the positional
table allows computes. What bounds the towers on an H100 is operations (3
TF32 products over 495 TFLOP/s in f32, bf16 products over 989); the
sources' headers say how the chain answers that.

Weight tuples are in the JAX layout (Dense kernels (in, out)), as
`fast_eval.weights_for_branch` / `context_weights_for_branch` read them
from a model:
  query:  (wp, bp, pos, g1, b1, wq, bq, wk, bk, wv, bv, wo, bo, g2, b2, wm)
  video:  the same 15, then (wm, bm) of out_mapping_linear
with the input LayerNorm's affine folded into (wp, bp).

The kernels read the weights as `pack_weights` lays them out, which the
eval and the serving `Retriever` do once (`fast_eval.tower_weights`), not
once per launch: every product's weight K-major in the tower dtype, and
every width the chain sees (input width, hidden size, head dims)
zero-padded to a multiple of 8, so the kernels take any shape the model
has.

The entry points pad and mask the inputs like the Pallas wrappers (query
tokens to a multiple of 8, positions past the learned table forced to
padding), then run the CUDA kernels for a CUDA tensor, or the plain
PyTorch version (`tower_plain`, on the weight tuples) for a CPU tensor.
Under a torch profiler each call of `query_towers`, `context_towers` and
`quantize_frames_q8` is one span (kernels/query_tower,
kernels/context_tower, kernels/quantize_q8; `utils/tracing.py`), on
either path.
The plain version rounds to the tower dtype at the Pallas kernel's points
and keeps IEEE f32 products; the CPU tests hold it against the Pallas
kernels in interpret mode, `tower_packed_plain` (the plain version on the
packed operands) against it bitwise, and an emulation of the kernels'
split arithmetic against both.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from dldkd_tpu_torch.utils.tracing import traced

# launches of the CUDA chains and of the int8 epilogue since the counts
# were last set to 0; the chains also by their dtype (query_tower_f32, ...)
# and, when the launch packs one branch (the one-branch Pallas kernels
# `fused_query_tower` / `fused_context_tower`), as query_tower_1br /
# context_tower_1br; the epilogue's transposed write (q8_transposed) as
# context_tower_q8_t
LAUNCHES = {"query_tower": 0, "query_tower_bf16": 0, "query_tower_f32": 0,
            "query_tower_1br": 0,
            "context_tower": 0, "context_tower_bf16": 0,
            "context_tower_f32": 0, "context_tower_1br": 0,
            "context_tower_q8": 0, "context_tower_q8_t": 0}
# calls of pack_weights since the counts were last set to 0, by tower kind
PACKS = {"query": 0, "context": 0}

NEG_BIG = -10000.0   # the model's additive attention mask value
NEG_INF = -1e10      # pooling mask value (ops.masking.NEG_INF)
INT8_SCALE = 127.0   # symmetric quantization of cosine components

Weights = Tuple[torch.Tensor, ...]


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


@traced("kernels/quantize_q8")
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


def _quantize_entry():
    from dldkd_tpu_torch.ops.kernels.build import bind

    return bind("tower", "tower_quantize_q8", 2, 9)


def _launch_quantize(x: torch.Tensor, y: torch.Tensor, stream) -> None:
    """The epilogue kernel on contiguous x (..., H) in the tower dtype into
    int8 y of the same shape, row for row; counts one launch."""
    from dldkd_tpu_torch.ops.kernels.build import check

    h = x.shape[-1]
    m = x.numel() // max(h, 1)
    check(_quantize_entry()(x.data_ptr(), y.data_ptr(), m, h, h, m, 1, 0, 0,
                            0, int(x.dtype == torch.bfloat16), stream),
          "tower_quantize_q8")
    LAUNCHES["context_tower_q8"] += 1


def _launch_quantize_t(y: torch.Tensor, hdim: int, seq_l: int,
                       out: torch.Tensor, v_off: int, stream) -> None:
    """The epilogue's transposed write: y (G, N seq_l, hp) rows of one
    sub-launch in the tower dtype (H = hdim valid columns) into out (G, l_p,
    nv_p, H) int8, the sub-launch's first video at v_off; counts one
    launch as context_tower_q8_t."""
    from dldkd_tpu_torch.ops.kernels.build import check

    g_n, m, hp = y.shape
    _, l_p, nv_p, _ = out.shape
    check(_quantize_entry()(y.data_ptr(), out.data_ptr(), g_n * m, hdim, hp,
                            m, seq_l, nv_p, l_p, v_off,
                            int(y.dtype == torch.bfloat16), stream),
          "tower_quantize_q8 (transposed)")
    LAUNCHES["context_tower_q8_t"] += 1


def q8_reciprocal_mismatches(device) -> int:
    """The bf16 epilogue's quotient against the divide on every pair of
    bf16 values (2^32 pairs: each value x against each norm n, 1e-12 clamp
    included): the count of pairs whose bf16 xn differs from
    round_bf16(x / max(n, 1e-12)), which the kernel's one reciprocal a row
    must leave at 0 (csrc/tower.cu, `tower_q8_reciprocal_check`). Runs on
    the card only; not a launch of the epilogue."""
    from dldkd_tpu_torch.ops.kernels.build import bind, check

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("q8_reciprocal_mismatches: needs a CUDA device")
    count = torch.zeros(1, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        check(bind("tower", "tower_q8_reciprocal_check", 1, 0)(
            count.data_ptr(), torch.cuda.current_stream().cuda_stream),
            "tower_q8_reciprocal_check")
    return int(count.item())


def q8_transposed_plain(rows: torch.Tensor) -> torch.Tensor:
    """Plain version of the transposed write: int8 rows (Nv_p, L_p, H) of
    padded videos and frames, in the TPU scoring layout (L_p, Nv_p, H)."""
    return rows.permute(1, 0, 2).contiguous()


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

def _r8(n: int) -> int:
    return -(-n // 8) * 8


def _head_columns(hdim: int, n_heads: int) -> torch.Tensor:
    """Column of each of the hdim Q/K/V (or context) dims in the kernels'
    layout, where each head's dims are zero-padded to a multiple of 8."""
    dh = hdim // n_heads
    return (torch.arange(n_heads)[:, None] * _r8(dh)
            + torch.arange(dh)[None]).reshape(-1)


def pack_weights(weights: Sequence[Weights], dtype: torch.dtype,
                 n_heads: int, device=None) -> Dict[str, torch.Tensor]:
    """The kernel chain's operands for one launch over the G = len(weights)
    branches of one hidden size H with n_heads heads, in the layout the
    kernels read; made once per eval or Retriever model
    (fast_eval.tower_weights). Widths are padded with zeros to multiples of
    8: the input width D to Dp, H to Hp, each head's H / n_heads dims to
    dhp (Hq = n_heads dhp). Each product's weight is transposed, (N, K)
    K-major, in the tower dtype. The rest is f32 (holding tower-dtype
    values where the Pallas kernel casts them):
      wp    the folded projections stacked (one read of the raw input for
            all branches): (G Hp, Dp); bp (G Hp)
      pos   every branch's whole positional table side by side, zero rows
            past a shorter one: (P, G Hp); a launch adds its first rows
      g1, b1, g2, b2, bo   (G, Hp)
      wqkv  Q|K|V per branch, heads at dhp columns: (G, 3 Hq, Hp);
            bqkv (G, 3 Hq)
      wo    (G, Hp, Hq)
      query: wm (G, Hp), the pooling vectors;
      video: wm (G, Hp, Hp) and bm (G, Hp), out_mapping_linear;
      dims  (H, n_heads, D), on the CPU."""
    kind = "query" if len(weights[0]) == 16 else "context"
    d, hdim = weights[0][0].shape
    if hdim % n_heads:
        raise ValueError(f"pack_weights: hidden size {hdim} is not a "
                         f"multiple of {n_heads} heads")
    PACKS[kind] += 1
    f32 = torch.float32
    g_n, dp, hp = len(weights), _r8(d), _r8(hdim)
    hq = n_heads * _r8(hdim // n_heads)
    heads = _head_columns(hdim, n_heads).to(device)

    def cast(w):  # a value the kernel reads in the tower dtype, as f32
        return w.to(device=device, dtype=dtype).float()

    def zeros(*shape):
        return torch.zeros(shape, dtype=f32, device=device)

    def vec(i, cast_to=f32):  # (G, Hp), zeros past H
        out = zeros(g_n, hp)
        for b, w in enumerate(weights):
            out[b, :hdim] = w[i].to(device=device, dtype=cast_to).float()
        return out

    packed = {}

    def product(name, kn):
        """kn: the (..., K, N) weight, padded; stored (..., N, K)."""
        packed[name] = kn.transpose(-1, -2).contiguous().to(dtype)

    wp = zeros(dp, g_n * hp)
    wqkv = zeros(g_n, hp, 3 * hq)
    wo = zeros(g_n, hq, hp)
    n_pos = max(w[2].shape[0] for w in weights)
    pos = zeros(n_pos, g_n * hp)
    for b, w in enumerate(weights):
        c = slice(b * hp, b * hp + hdim)
        wp[:d, c] = cast(w[0])
        pos[:w[2].shape[0], c] = cast(w[2])
        for i, j in enumerate((5, 7, 9)):
            wqkv[b, :hdim, i * hq + heads] = cast(w[j])
        wo[b, heads, :hdim] = cast(w[11])
    product("wp", wp)
    packed["bp"] = vec(1, cast_to=dtype).reshape(-1)
    packed["pos"] = pos
    packed["g1"], packed["b1"] = vec(3), vec(4)
    product("wqkv", wqkv)
    bqkv = zeros(g_n, 3 * hq)
    for b, w in enumerate(weights):
        for i, j in enumerate((6, 8, 10)):
            bqkv[b, i * hq + heads] = w[j].to(device=device, dtype=f32)
    packed["bqkv"] = bqkv
    product("wo", wo)
    packed["bo"] = vec(12)
    packed["g2"], packed["b2"] = vec(13), vec(14)
    if kind == "query":
        packed["wm"] = zeros(g_n, hp)
        for b, w in enumerate(weights):
            packed["wm"][b, :hdim] = cast(w[15].reshape(-1))
    else:
        wm = zeros(g_n, hp, hp)
        for b, w in enumerate(weights):
            wm[b, :hdim, :hdim] = cast(w[15])
        product("wm", wm)
        packed["bm"] = vec(16)
    packed["dims"] = torch.tensor([hdim, n_heads, d])
    return packed


def _pos_rows(packed, l: int, pos_rows=None) -> int:
    """Rows of each sequence that get a positional row: the first l (or
    pos_rows), at most the packed table's."""
    return min(l if pos_rows is None else pos_rows, packed["pos"].shape[0])


def unpack_weights(packed: Dict[str, torch.Tensor], dtype: torch.dtype,
                   l: int, pos_rows=None) -> List[Weights]:
    """Each branch's weight tuple read back from the packed operands, in the
    JAX layout and the true widths, with the positions of a launch over
    sequences of l rows (the table's first `_pos_rows` rows, zeros after)."""
    hdim, n_heads, d = (int(v) for v in packed["dims"])
    g_n, hp = packed["g1"].shape
    hq = n_heads * _r8(hdim // n_heads)
    heads = _head_columns(hdim, n_heads).to(packed["g1"].device)
    h = slice(0, hdim)

    def kn(name, b=None):  # a product's weight back to (K, N), padded
        w = packed[name] if b is None else packed[name][b]
        return w.transpose(-1, -2)

    rows = _pos_rows(packed, l, pos_rows)
    pos = F.pad(packed["pos"][:rows], (0, 0, 0, l - rows))
    wp = kn("wp")
    out = []
    for b in range(g_n):
        c = slice(b * hp, b * hp + hdim)
        wqkv, bqkv = kn("wqkv", b), packed["bqkv"][b]
        q, k, v = (i * hq + heads for i in range(3))
        w = (wp[:d, c], packed["bp"][c], pos[:, c], packed["g1"][b, h],
             packed["b1"][b, h], wqkv[:hdim, q], bqkv[q], wqkv[:hdim, k],
             bqkv[k], wqkv[:hdim, v], bqkv[v], kn("wo", b)[heads, :hdim],
             packed["bo"][b, h], packed["g2"][b, h], packed["b2"][b, h])
        if "bm" in packed:
            w += (kn("wm", b)[:hdim, :hdim], packed["bm"][b, h])
        else:
            w += (packed["wm"][b, h].reshape(-1, 1),)
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


def tower_cuda(x: torch.Tensor, mask: torch.Tensor,
               packed: Dict[str, torch.Tensor], n_heads: int,
               dtype: torch.dtype, kind: str, emit_q8: bool = False,
               pos_rows=None, q8_out=None) -> List[torch.Tensor]:
    """The CUDA chain for one launch over the branches in `packed`
    (pack_weights, in `dtype` and for n_heads heads); same contract as
    tower_plain. x and mask are contiguous f32 CUDA tensors; each
    sequence's first `pos_rows` rows (default: all) get positional rows.

    One chain for both dtypes, all csrc/tower_mma.cu: the input
    normalization; the folded projection with its epilogue (bias, ReLU,
    positions) and the LayerNorm (`tower_gemm_ln`, a thread block cluster
    owning whole rows of one branch); the Q|K|V product (wgmma); the
    attention (mma.sync, tiled over keys: any L); the output product with its
    residual and LayerNorm, and in the query tower the pooling too
    (`tower_gemm_ln`); in the video tower out_mapping_linear, then, with
    emit_q8, csrc/tower.cu's int8 epilogue. Query: 5 launches; video: 6,
    7 with emit_q8. bf16 runs bf16 products with f32 accumulation. f32 runs
    every product in 3xTF32 (big.big + big.small + small.big of TF32
    parts, f32-grade; the Pallas trunk's f32 products run at the global
    "highest"): each product splits its operands in shared memory as they
    land, so the chain's buffers are plain f32. The buffers carry the
    packer's padded widths (zeros past the true ones); the outputs come
    back at the true widths. With emit_q8 (video towers) the out_mapping
    product goes to a scratch buffer and the int8 epilogue writes the
    outputs; q8_out = (out, v_off) makes it the transposed write into out
    (G, L_p, Nv_p, H) int8 at video v_off (`_launch_quantize_t`), and
    returns out's branches. Bound: operations, 3 TF32 products over 495
    TFLOP/s in f32 and the bf16 products over 989 TFLOP/s in bf16; at the
    query tower's sizes the chain's five launches set the floor."""
    from dldkd_tpu_torch.ops.kernels.build import bind, check

    hdim, heads_packed, d_packed = (int(v) for v in packed["dims"])
    if heads_packed != n_heads:
        raise ValueError(f"tower_cuda: weights packed for {heads_packed} "
                         f"heads, called with {n_heads}")
    n, l, d = x.shape
    if d != d_packed:
        raise ValueError(f"tower_cuda: input width {d} vs packed weights "
                         f"{d_packed}")
    g_n, hp = packed["g1"].shape
    dh = hdim // n_heads
    hq = n_heads * _r8(dh)
    dp = _r8(d)
    m = n * l
    ghp = g_n * hp
    bf = int(dtype == torch.bfloat16)
    rows = _pos_rows(packed, l, pos_rows)
    dev = x.device
    if x.data_ptr() % 16:  # the normalization reads 16-byte rows
        x = x.clone()
    p = {k: v.data_ptr() for k, v in packed.items() if k != "dims"}

    mma = bind("tower_mma", "tower_gemm_mma", 6, 18)
    mma_ln = bind("tower_mma", "tower_gemm_ln", 11, 22)

    # Each buffer is made when its kernel writes it and dropped after its
    # last reader, so the launch's peak holds only the live ones (at 200
    # videos: the qkv product, its input and attention's output). Every
    # kernel runs on the current stream, which orders a block's reuse.
    def new(*shape):
        return torch.empty(shape, dtype=dtype, device=dev)

    with torch.cuda.device(dev):
        s = torch.cuda.current_stream().cuda_stream

        def gemm(what, a, w, bias, c, res, dims, strides, relu=0,
                 batch=g_n, pos=None):
            """dims (M, N, K, lda, ldw, ldc, ldp, ldr), strides (sa, sw, sb,
            sc, sr)"""
            check(mma(a, p[w], bias, c, pos, res, *dims, *strides, relu, l,
                      rows, batch, 1 - bf, s), f"tower_gemm_mma ({what})")

        def gemm_ln(what, a, w, bias, c, res, ln, dims, strides, sg,
                    relu=0, batch=g_n, pos=None, pool=None):
            """gemm's product and epilogue, then the LayerNorm `ln` (its
            gamma and beta) of each row's groups of hp columns; pool =
            (wm, pooled): pool each sequence's rows into pooled instead"""
            wm, pooled = (None, None) if pool is None else pool
            check(mma_ln(a, p[w], bias, c, pos, res, p[ln[0]], p[ln[1]], wm,
                         None if pool is None else mask.data_ptr(), pooled,
                         *dims, *strides, sg, relu, l, rows, hp, hdim,
                         0 if pool is None else l, batch, 1 - bf, s),
                  f"tower_gemm_ln ({what})")

        xn = new(m, dp)
        check(bind("tower_mma", "tower_normalize", 2, 4)(
            x.data_ptr(), xn.data_ptr(), m, d, dp, 1 - bf, s),
            "tower_normalize")
        # folded projection over every branch's columns (one read of x),
        # + positions, LayerNorm; a cluster per (rows, branch)
        h2 = new(m, ghp)
        gemm_ln("projection", xn.data_ptr(), "wp", p["bp"], h2.data_ptr(),
                None, ("g1", "b1"), (m, ghp, dp, dp, dp, ghp, ghp, 0),
                (0, 0, 0, 0, 0), 0, relu=1, batch=1, pos=p["pos"])
        del xn
        qkv = new(g_n, m, 3 * hq)
        gemm("qkv", h2.data_ptr(), "wqkv", p["bqkv"], qkv.data_ptr(), None,
             (m, 3 * hq, hp, ghp, hp, 3 * hq, 0, 0),
             (hp, 3 * hq * hp, 3 * hq, m * 3 * hq, 0))
        ctx = new(g_n, m, hq)
        check(bind("tower_mma", "tower_attention_mma", 3, 7, 1)(
            qkv.data_ptr(), mask.data_ptr(), ctx.data_ptr(), g_n, n, l, hq,
            n_heads, _r8(dh), 1 - bf, 1.0 / math.sqrt(dh), s),
            "tower_attention_mma")
        del qkv
        # output projection + residual, LayerNorm (and the query tower's
        # pooling)
        out_dims = (m, hp, hq, hq, hq, ghp, 0, ghp)
        out_strides = (m * hq, hp * hq, hp, hp, hp)
        if kind == "query":
            pooled = torch.empty((g_n, n, hdim), dtype=torch.float32,
                                 device=dev)
            # the LayerNorm's rows go to device memory only when a block
            # cannot keep them (csrc/tower_mma.cu, rows_pool_in_smem)
            spill = new(m, ghp) if pool_rows_spill(hp, l) else None
            gemm_ln("output", ctx.data_ptr(), "wo", p["bo"],
                    None if spill is None else spill.data_ptr(),
                    h2.data_ptr(), ("g2", "b2"), out_dims, out_strides, hp,
                    pool=(p["wm"], pooled.data_ptr()))
            LAUNCHES["query_tower"] += 1
            LAUNCHES["query_tower_" + ("bf16" if bf else "f32")] += 1
            if g_n == 1:
                LAUNCHES["query_tower_1br"] += 1
            return list(pooled.unbind(0))
        out = new(m, ghp)
        gemm_ln("output", ctx.data_ptr(), "wo", p["bo"], out.data_ptr(),
                h2.data_ptr(), ("g2", "b2"), out_dims, out_strides, hp)
        del ctx, h2
        y = new(g_n, m, hp)
        gemm("out_mapping", out.data_ptr(), "wm", p["bm"], y.data_ptr(),
             None, (m, hp, hp, ghp, hp, hp, 0, 0), (hp, hp * hp, hp, m * hp,
                                                   0))
        del out
        if emit_q8 and q8_out is not None:
            _launch_quantize_t(y, hdim, l, q8_out[0], q8_out[1], s)
            y = None
        elif emit_q8:  # zero columns past H leave each row's sum unchanged
            y8 = torch.empty((g_n, m, hp), dtype=torch.int8, device=dev)
            _launch_quantize(y, y8, s)
            y = y8
    LAUNCHES["context_tower"] += 1
    LAUNCHES["context_tower_" + ("bf16" if bf else "f32")] += 1
    if g_n == 1:
        LAUNCHES["context_tower_1br"] += 1
    if y is None:
        return list(q8_out[0].unbind(0))
    outs = [t.view(n, l, hp) for t in y.unbind(0)]
    if hp != hdim:
        outs = [t[..., :hdim].contiguous() for t in outs]
    return outs


def pool_rows_spill(hp: int, l: int) -> bool:
    """Whether the query tower's last product sends the LayerNorm's rows
    through device memory before pooling them: a branch wider than a
    cluster's eight 128-column blocks, or a sequence longer than a block's
    64 rows (csrc/tower_mma.cu, rows_pool_in_smem)."""
    return hp > 8 * 128 or l > 64


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


_INT32_MAX = 2 ** 31 - 1
_GRID_YZ_MAX = 65535   # a CUDA grid's y and z dimensions


def sequences_per_launch(l: int, d: int, packed: Dict[str, torch.Tensor]
                         ) -> int:
    """The most sequences of l rows of width d that one launch of the CUDA
    chain takes. The chain's C entries take sizes and strides as int32, so
    every buffer of the launch (the (N l, d) input, its normalization, the
    qkv product (G, N l, 3 Hq), ...) keeps its element count within int32;
    the products' grid holds N l / 64 row tiles and the attention's grid N
    sequences, each at most 65,535. At the serving width (d 1,024, two
    branches of 384 in 4 heads) and l = 128 that is 7,281 videos."""
    hdim, n_heads, _ = (int(v) for v in packed["dims"])
    g_n, hp = packed["g1"].shape
    widest = max(_r8(d), g_n * hp, g_n * 3 * n_heads * _r8(hdim // n_heads))
    return max(1, min(_GRID_YZ_MAX, _INT32_MAX // (widest * l),
                      _GRID_YZ_MAX * 64 // l))


def _run(x, mask, weights, n_heads, dtype, kind, l, plain, emit_q8=False,
         packed=None, q8_transposed=False):
    """One launch over sequences of l rows (x padded past them): the plain
    version on the weight tuples on the CPU or with plain=True, else the
    CUDA chain on the packed operands (packed here when not given), in as
    many launches of at most `sequences_per_launch` sequences as it
    takes (one at every block size the eval and serving default to). With
    q8_transposed (and emit_q8) the int8 rows come back as (L_p, Nv_p, H)
    per branch, x's padded frames and videos included: every sub-launch
    writes its videos at their offset in one output buffer."""
    if plain or x.device.type == "cpu":
        weights = [_with_pos(w, l, x.shape[1]) for w in weights]
        outs = tower_plain(x, mask, weights, n_heads, dtype, kind, emit_q8)
        if q8_transposed:
            outs = [q8_transposed_plain(t) for t in outs]
        return outs
    if packed is None:
        packed = pack_weights(weights, dtype, n_heads, x.device)
    cap = sequences_per_launch(x.shape[1], x.shape[2], packed)
    q8_out = None
    if q8_transposed:
        nv_p, l_p = x.shape[:2]
        q8_out = torch.empty((len(weights), l_p, nv_p, int(packed["dims"][0])),
                             dtype=torch.int8, device=x.device)
    parts = [tower_cuda(x[s:s + cap].contiguous(),
                        mask[s:s + cap].contiguous(), packed, n_heads, dtype,
                        kind, emit_q8, pos_rows=l,
                        q8_out=None if q8_out is None else (q8_out, s))
             for s in range(0, max(x.shape[0], 1), cap)]
    if q8_out is not None:
        return parts[-1]
    if len(parts) == 1:
        return parts[0]
    return [torch.cat(outs) for outs in zip(*parts)]


@traced("kernels/query_tower")
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


@traced("kernels/context_tower")
def context_towers(x: torch.Tensor, mask: torch.Tensor,
                   weights: Sequence[Weights], n_heads: int,
                   dtype: torch.dtype, what: str,
                   plain: bool = False, emit_q8: bool = False,
                   packed=None, q8_transposed: bool = False
                   ) -> List[torch.Tensor]:
    """Frame features (Nv, L, H) in the tower dtype for each weight tuple,
    in one launch; with emit_q8 the int8 index rows (Nv, L, H) instead
    (`quantize_frames_q8` of those frame features). packed: as for
    query_towers.

    q8_transposed (with emit_q8; ignored without it, as in
    dldkd_tpu/ops/pallas/query_tower.py:455): the int8 rows PADDED and in
    the TPU scoring layout, (L_p, Nv_p, H) per branch, as the Pallas
    wrapper pads them (:458-465): videos to a multiple of
    `sim_max.V_LANES`, frames to max(8, `sim_max.pick_q8_l_tile(H)`). The
    towers run on the padded rows, so padded positions hold computed values
    (masked out by `sim_max.q8_index_bias(mask, L_p, Nv_p)`)."""
    _check_inputs(x, mask, weights, dtype, what)
    lv = x.shape[1]
    for w in weights:
        _check_pos_table(w[2], lv, what)
    q8_t = bool(emit_q8 and q8_transposed)
    if q8_t:
        from dldkd_tpu_torch.ops.kernels.sim_max import V_LANES, pick_q8_l_tile

        l_grid = max(8, pick_q8_l_tile(weights[0][0].shape[1]))
        lv_p = -(-lv // l_grid) * l_grid
        nv_p = -(-x.shape[0] // V_LANES) * V_LANES
        x = F.pad(x, (0, 0, 0, lv_p - lv, 0, nv_p - x.shape[0]))
        mask = F.pad(mask, (0, lv_p - lv, 0, nv_p - mask.shape[0]))
    return _run(x, mask, weights, n_heads, dtype, "context", lv, plain,
                emit_q8, packed, q8_t)


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
                             plain: bool = False, emit_q8: bool = False,
                             q8_transposed: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both branches' frame features (or int8 index rows, emit_q8) from
    one read of the raw frames; with emit_q8 and q8_transposed the int8
    rows padded in the TPU scoring layout (L_p, Nv_p, H) (`context_towers`),
    to pair with `sim_max.q8_index_bias(mask, L_p, Nv_p)`."""
    a, b = context_towers(x, mask, [weights_a, weights_b], n_heads, dtype,
                          "fused_context_tower_dual", plain, emit_q8,
                          q8_transposed=q8_transposed)
    return a, b
