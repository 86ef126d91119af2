#!/usr/bin/env python3
"""The towers' epilogues on one CUDA card, per launch at the main path's
shapes.

The LayerNorm and pooling: in this checkout, folded into the epilogues of
the whole-row products (`tower_gemm_ln`, csrc/tower_mma.cu), timed against
the same products without them (`tower_gemm_mma`) and checked against
their plain PyTorch versions; with --parent DIR whose csrc/tower.cu still
has the separate `tower_layernorm` and `tower_pool`, also those, built
with the port's nvcc flags and timed on the same values, with
`torch.nn.functional.layer_norm` on those values as the LayerNorm's
yardstick (`library_ms`; the port never calls it).

The int8 epilogue (csrc/tower.cu `tower_quantize_q8`): the reciprocal's
exhaustive check (every bf16 value against every bf16 norm), then per
dtype one launch at each of `Q8_CASES` (the eval's context batch of 200
videos, one branch of it, the streaming block of 2,048 videos in place
and transposed, the serving corpus one branch a launch) bitwise against
its plain version; with --parent DIR also DIR's `tower_quantize_q8` (e.g.
the parent commit unpacked with `git archive`) on the same rows, timed in
turns with this checkout's and held bitwise against it, there and on rows
that reach every branch (`q8_edge_rows`: zeros, norms under 1e-12, ties,
inf, NaN) at widths 48 to 1,024 in both modes.

Shapes: the serving model's widths (hidden 384, two branches, 4 heads,
query 768 -> 384 on 32 tokens, video 1024 -> 384 on 128 frames), the
eval's 50 queries, serving's 256 and the eval's 200-video context batch,
in bf16 and f32; weights packed from a seeded model as the eval packs
them, activations seeded. Each record: CUDA-event time per launch over 50
launches ("ms"), the kernels' device time per launch (torch.profiler,
"device_ms"), and the least time for the work ("bound_ms": bytes over
3.35 TB/s, each input read once, each output written once;
"share_of_bound": bound over device time; for the int8 epilogue also
its rate in TB/s beside a device-to-device copy's of its input,
"copy_tb_per_s").

    python3 dldkd_tpu_torch/tools/tower_epilogues.py [--parent DIR]
    python3 dldkd_tpu_torch/tools/tower_epilogues.py --compare A.pt B.pt

--compare prints, per case, the largest difference between two files of
tower outputs written by `tower_variants.py --save` (one per checkout,
same seeded inputs) and whether they are bitwise equal.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# (kind, sequences, rows per sequence, input width)
SHAPES = (("query", 50, 32, 768), ("query", 256, 32, 768),
          ("context", 200, 128, 1024))
HIDDEN, HEADS = 384, 4  # the serving model's hidden size and heads


def bound_ms(n_bytes: float) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


def cuda_ms(fn, n: int = 50, warmup: int = 3) -> float:
    """Mean time of fn() over n back-to-back calls, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn, n: int = 20) -> float:
    """The kernels' device time per call of fn() (torch.profiler), without
    the host's time between launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type == DeviceType.CUDA) / n / 1e3


def _timed(fn) -> dict:
    return {"ms": cuda_ms(fn), "device_ms": device_ms(fn)}


def parent_library(tree: str):
    """DIR's csrc/tower.cu built with the port's nvcc flags into the build
    directory's `parent/`, loaded with ctypes."""
    from dldkd_tpu_torch.ops.kernels import build

    out_dir = build.BUILD_DIR / "parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "libtower_parent.so"
    src = os.path.join(os.path.abspath(tree), "dldkd_tpu_torch", "csrc",
                       "tower.cu")
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                           str(so), src], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {src}\n{proc.stdout}"
                         f"{proc.stderr}")
    lib = ctypes.CDLL(str(so))

    def entry(symbol, n_ptrs, n_ints):
        fn = getattr(lib, symbol)
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        return fn

    entries = {"layernorm": ("tower_layernorm", 4, 6),
               "pool": ("tower_pool", 4, 7),
               "quantize_q8": ("tower_quantize_q8", 2, 9)}
    return {k: entry(*e) for k, e in entries.items() if hasattr(lib, e[0])}


def _packed(dtype, dev):
    """Both towers' packed operands of the seeded serving model."""
    import torch

    from dldkd_tpu_torch.config import ModelConfig
    from dldkd_tpu_torch.models import DLDKD
    from dldkd_tpu_torch.ops.fast_eval import tower_weights

    cfg = ModelConfig(visual_input_size=1024, query_input_size=768,
                      inheritance_hidden=HIDDEN, exploration_hidden=HIDDEN,
                      max_ctx_l=128, max_desc_l=30, n_heads=HEADS,
                      double_branch=True, dtype=dtype)
    model = DLDKD(cfg).init_weights(torch.Generator().manual_seed(2))
    tw = tower_weights(model.eval(), dev)
    return {k: tw["packed"][k][0] for k in ("query", "context")}


# The fused rows against the plain LayerNorm and pooling of the same
# product's rows: sums in another order, so a value may round the other
# way. Within one rounding of the tower dtype: |got - want| <= atol + rtol
# |want| for rows (bf16: 2^-7 relative, one ulp), and for pooled vectors
# (each a convex sum of rows) rtol times the largest row value.
ROUNDING = {"bfloat16": (2.0 ** -7, 1e-6), "float32": (1e-5, 1e-5)}


def _agreement(got, want, dtype, scale=None) -> dict:
    """The largest difference, the count of differing values and whether
    every difference is within one rounding (ROUNDING) of `scale` (default
    |want|)."""
    rtol, atol = ROUNDING[dtype]
    diff = (got.float() - want.float()).abs()
    scale = want.float().abs() if scale is None else scale
    return {"max_abs_err": float(diff.max()),
            "n_differ": int((diff > 0).sum()),
            "within_one_rounding": bool((diff <= atol + rtol * scale).all())}


def _plain_ln(y, gamma, beta, hdim, dtype):
    """The plain LayerNorm (query_tower._ln) of each branch's columns of y
    (M, G hp), at the true width, back in y's layout (zeros past hdim)."""
    import torch

    from dldkd_tpu_torch.ops.kernels.query_tower import _ln

    m, ghp = y.shape
    g_n, hp = gamma.shape
    v = y.float().view(m, g_n, hp)[..., :hdim]
    out = torch.zeros(m, g_n, hp, device=y.device)
    out[..., :hdim] = _ln(v, gamma[:, :hdim], beta[:, :hdim], dtype)
    return out.view(m, ghp)


def case_records(kind, n, l, d, dtype, packed, parent=None) -> list:
    """The records of one shape and dtype (see the module's docstring)."""
    import torch

    from dldkd_tpu_torch.ops.kernels.build import bind, check
    from dldkd_tpu_torch.ops.kernels.query_tower import pool_plain

    dev = packed["g1"].device
    tdt = getattr(torch, dtype)
    item = torch.tensor([], dtype=tdt).element_size()
    f32 = int(dtype == "float32")
    bf = 1 - f32
    g_n, hp = packed["g1"].shape
    hdim = HIDDEN
    hq = hp  # 4 heads of 96 dims: no head padding at the serving width
    dp = -(-d // 8) * 8
    m, ghp = n * l, g_n * hp
    gen = torch.Generator(device=dev).manual_seed(5)
    p = {k: v.data_ptr() for k, v in packed.items() if k != "dims"}
    xn = torch.randn(m, dp, generator=gen, device=dev).to(tdt)
    ctx = (0.5 * torch.randn(g_n, m, hq, generator=gen, device=dev)).to(tdt)
    lengths = torch.randint(3, l + 1, (n,), generator=gen, device=dev)
    mask = (torch.arange(l, device=dev)[None] < lengths[:, None]).float()
    mma = bind("tower_mma", "tower_gemm_mma", 6, 18)
    mma_ln = bind("tower_mma", "tower_gemm_ln", 11, 22)
    stream = torch.cuda.current_stream().cuda_stream

    def empty(*shape, dt=tdt):
        return torch.empty(shape, dtype=dt, device=dev)

    h, h2, o, out = (empty(m, ghp) for _ in range(4))
    pooled = empty(g_n, n, hdim, dt=torch.float32)
    proj = (m, ghp, dp, dp, dp, ghp, ghp, 0)
    outp = (m, hp, hq, hq, hq, ghp, 0, ghp)
    outs = (m * hq, hp * hq, hp, hp, hp)

    rows = min(l, packed["pos"].shape[0])  # rows with a positional row

    def proj_plain():
        check(mma(xn.data_ptr(), p["wp"], p["bp"], h.data_ptr(), p["pos"],
                  None, *proj, 0, 0, 0, 0, 0, 1, l, rows, 1, f32, stream),
              "tower_gemm_mma (projection)")

    def proj_ln():
        check(mma_ln(xn.data_ptr(), p["wp"], p["bp"], h2.data_ptr(),
                     p["pos"], None, p["g1"], p["b1"], None, None, None,
                     *proj, 0, 0, 0, 0, 0, 0, 1, l, rows, hp, hdim, 0, 1,
                     f32, stream), "tower_gemm_ln (projection)")

    def out_plain():
        check(mma(ctx.data_ptr(), p["wo"], p["bo"], o.data_ptr(), None,
                  h2.data_ptr(), *outp, *outs, 0, l, rows, g_n, f32,
                  stream), "tower_gemm_mma (output)")

    def out_ln():
        pool = kind == "query"
        check(mma_ln(ctx.data_ptr(), p["wo"], p["bo"],
                     None if pool else out.data_ptr(), None, h2.data_ptr(),
                     p["g2"], p["b2"], p["wm"] if pool else None,
                     mask.data_ptr() if pool else None,
                     pooled.data_ptr() if pool else None, *outp, *outs, hp,
                     0, l, rows, hp, hdim, l if pool else 0, g_n, f32,
                     stream), "tower_gemm_ln (output)")

    # the fused rows against the plain LayerNorm / pooling of the plain
    # products' rows (the same products, so only the epilogue differs)
    proj_plain()
    proj_ln()
    out_plain()
    out_ln()
    torch.cuda.synchronize()
    ln1 = _plain_ln(h, packed["g1"], packed["b1"], hdim, tdt)
    agree_proj = _agreement(h2, ln1, dtype)
    ln2 = _plain_ln(o, packed["g2"], packed["b2"], hdim, tdt)
    if kind == "query":
        want = torch.stack([pool_plain(
            ln2.view(m, g_n, hp)[:, b, :hdim].reshape(n, l, hdim), mask,
            packed["wm"][b, :hdim].reshape(-1, 1), tdt)
            for b in range(g_n)])
        agree_out = _agreement(pooled, want, dtype,
                               scale=ln2.abs().max())
    else:
        agree_out = _agreement(out, ln2, dtype)

    shape = {"kind": kind, "n": n, "l": l, "d": d, "hidden": hdim,
             "branches": g_n, "dtype": dtype}
    ln_bytes = 2 * m * ghp * item + 2 * ghp * 4  # read and write the rows
    pool_bytes = m * ghp * item + n * l * 4 + ghp * 4 + g_n * n * hdim * 4
    x_ln = h.view(m * g_n, hp)
    g_t, b_t = packed["g1"][0].to(tdt), packed["b1"][0].to(tdt)
    recs = [
        {"what": "projection (step 2)", **shape,
         "gemm_mma": _timed(proj_plain), "gemm_ln": _timed(proj_ln),
         "vs_plain": agree_proj},
        {"what": "output (step 5)" + (" + pooling" if kind == "query"
                                      else ""), **shape,
         "gemm_mma": _timed(out_plain), "gemm_ln": _timed(out_ln),
         "vs_plain": agree_out},
        {"what": "layernorm yardstick", **shape,
         "library_ms": cuda_ms(lambda: torch.nn.functional.layer_norm(
             x_ln, (hp,), g_t, b_t, 1e-5)),
         "bound_ms": bound_ms(ln_bytes), "bound_by": "bytes"}]
    for r in recs[:2]:
        r["epilogue_ms"] = r["gemm_ln"]["ms"] - r["gemm_mma"]["ms"]
        r["epilogue_device_ms"] = (r["gemm_ln"]["device_ms"]
                                   - r["gemm_mma"]["device_ms"])
    if parent is None or "layernorm" not in parent:
        return recs

    def par_ln(src, dst, gamma, beta):
        return lambda: check(parent["layernorm"](
            src.data_ptr(), dst.data_ptr(), gamma, beta, m, g_n, hdim, hp,
            ghp, bf, stream), "parent tower_layernorm")

    # outputs start as NaN: a value the kernel did not write shows
    y1, y2 = (torch.full((m, ghp), float("nan"), dtype=tdt, device=dev)
              for _ in range(2))
    ln_a = par_ln(h, y1, p["g1"], p["b1"])
    ln_b = par_ln(o, y2, p["g2"], p["b2"])
    ln_a()
    ln_b()
    torch.cuda.synchronize()
    recs.append({"what": "parent layernorm (steps 3, 7)", **shape,
                 **_timed(ln_a), "ms_output": cuda_ms(ln_b),
                 "bound_ms": bound_ms(ln_bytes), "bound_by": "bytes",
                 "vs_plain": [_agreement(y1, ln1, dtype),
                              _agreement(y2, ln2, dtype)],
                 "vs_fused": [_agreement(h2, y1, dtype),
                              _agreement(out, y2, dtype)
                              if kind == "context" else None]})
    if kind == "query":
        pp = torch.full((g_n, n, hdim), float("nan"), device=dev)
        pool = (lambda: check(parent["pool"](
            y2.data_ptr(), mask.data_ptr(), p["wm"], pp.data_ptr(), g_n, n,
            l, hdim, hp, ghp, bf, stream), "parent tower_pool"))
        pool()
        torch.cuda.synchronize()
        recs.append({"what": "parent pool (step 8)", **shape, **_timed(pool),
                     "bound_ms": bound_ms(pool_bytes), "bound_by": "bytes",
                     "library_ms": None,
                     "vs_plain": _agreement(pp, want, dtype,
                                            scale=ln2.abs().max()),
                     "vs_fused": _agreement(pooled, pp, dtype,
                                            scale=ln2.abs().max())})
    return recs


# The int8 epilogue (csrc/tower.cu) at its main paths' shapes, rows of the
# serving width: (what, rows a launch, (videos, frames) of the transposed
# write or None for the in-place one)
Q8_CASES = (("eval context batch, 200 videos x 2 branches", 2 * 200 * 128,
             None),
            ("one branch, 200 videos", 200 * 128, None),
            ("streaming block, 2,048 videos x 2 branches", 2 * 2048 * 128,
             None),
            ("transposed write, 2,048 videos x 2 branches", 2 * 2048 * 128,
             (2048, 128)),
            ("serving corpus, 2,179 videos, one branch a launch",
             2179 * 128, None))


def q8_case(what, rows, transposed, dtype, dev, parent=None) -> dict:
    """One launch of the int8 epilogue on `rows` seeded rows of HIDDEN
    values: this checkout's kernel and, with `parent`, the parent's entry
    on the same rows, timed in turns (this, parent, parent, this; CUDA
    events and device time a launch); each output bitwise against the
    plain version and against the other; the bytes bound (each value read
    once, each int8 written once) and its share of the device time."""
    import torch

    from dldkd_tpu_torch.ops.kernels.build import bind, check
    from dldkd_tpu_torch.ops.kernels.query_tower import (
        q8_transposed_plain, quantize_frames_q8_plain)

    tdt = getattr(torch, dtype)
    item = torch.tensor([], dtype=tdt).element_size()
    bf = int(dtype == "bfloat16")
    h = HIDDEN
    gen = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(rows, h, generator=gen, device=dev).to(tdt)
    if transposed is None:
        args = (rows, h, h, rows, 1, 0, 0, 0)
        shape = (rows, h)
        plain = lambda: quantize_frames_q8_plain(x)  # noqa: E731
    else:
        nv, l = transposed
        g_n = rows // (nv * l)
        args = (rows, h, h, nv * l, l, nv, l, 0)
        shape = (g_n, l, nv, h)
        plain = lambda: torch.stack([  # noqa: E731
            q8_transposed_plain(quantize_frames_q8_plain(b))
            for b in x.view(g_n, nv, l, h)])
    stream = torch.cuda.current_stream().cuda_stream
    mine = bind("tower", "tower_quantize_q8", 2, 9)
    y = torch.empty(shape, dtype=torch.int8, device=dev)

    def launch(entry, out):
        return lambda: check(entry(x.data_ptr(), out.data_ptr(), *args, bf,
                                   stream), "tower_quantize_q8")

    run = launch(mine, y)
    run()
    want = plain()
    torch.cuda.synchronize()
    b_ms = bound_ms(rows * h * (item + 1))
    # a yardstick of the card's streaming rate: a device-to-device copy of
    # the input (its bytes read and written once)
    x_copy = torch.empty_like(x)
    copy_ms = device_ms(lambda: x_copy.copy_(x))
    del x_copy
    rec = {"what": what, "dtype": dtype, "rows": rows, "hidden": h,
           "launch_shape": list(shape), "bitwise_vs_plain": torch.equal(
               y, want), "bound_ms": b_ms, "bound_by": "bytes",
           "library_ms": None,
           "plain_ms": cuda_ms(plain, n=3, warmup=1),
           "copy_tb_per_s": 2 * rows * h * item / copy_ms / 1e9}
    del want
    if parent is None:
        rec.update(_timed(run))
    else:
        y_p = torch.empty_like(y)
        prun = launch(parent["quantize_q8"], y_p)
        prun()
        torch.cuda.synchronize()
        rec["bitwise_vs_parent"] = torch.equal(y, y_p)
        turns = [_timed(f) for f in (run, prun, prun, run)]
        rec["ms"] = [turns[0]["ms"], turns[3]["ms"]]
        rec["device_ms"] = [turns[0]["device_ms"], turns[3]["device_ms"]]
        rec["parent_ms"] = [turns[1]["ms"], turns[2]["ms"]]
        rec["parent_device_ms"] = [turns[1]["device_ms"],
                                   turns[2]["device_ms"]]
        rec["parent_share_of_bound"] = b_ms / min(rec["parent_device_ms"])
    best = min(rec["device_ms"]) if isinstance(rec["device_ms"], list) \
        else rec["device_ms"]
    rec["share_of_bound"] = b_ms / best
    rec["tb_per_s"] = rows * h * (item + 1) / best / 1e9
    return rec


def q8_edge_rows(h, dtype, dev, seed=0):
    """4,099 rows of width h that reach every branch of the epilogue:
    values over many magnitudes, all-zero rows and rows of 1e-13 (norms
    under 1e-12), rows of four equal values (xn * 127 on the tie 63.5),
    rows of one value, and rows with an inf or a NaN."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    m = 4099
    x = torch.randn(m, h, generator=gen) * torch.exp(
        torch.randn(m, 1, generator=gen) * 20)
    x[:16] = 0.0
    x[16:24] = 1e-13
    x[24:40, :4] = torch.randn(16, 1, generator=gen)
    x[40:56, 0] = torch.randn(16, generator=gen)
    x[56, 3] = float("inf")
    x[57, 5] = -float("inf")
    x[58, 7] = float("nan")
    return x.to(dev, getattr(torch, dtype))


def q8_vs_parent_edges(dtype, dev, parent) -> dict:
    """This checkout's epilogue against the parent's entry on
    `q8_edge_rows` at widths 48, 60, 100, 384 and 1,024, in place and (rows
    of 31 frames, 7 videos of a 160-video output at offset 3) transposed:
    bitwise or not, per width and mode."""
    import torch

    from dldkd_tpu_torch.ops.kernels.build import bind, check

    bf = int(dtype == "bfloat16")
    stream = torch.cuda.current_stream().cuda_stream
    mine = bind("tower", "tower_quantize_q8", 2, 9)
    out = {}
    for h in (48, 60, 100, 384, 1024):
        x = q8_edge_rows(h, dtype, dev, seed=h)
        m = x.shape[0]
        ys = []
        for entry in (mine, parent["quantize_q8"]):
            y = torch.full((m, h), 77, dtype=torch.int8, device=dev)
            check(entry(x.data_ptr(), y.data_ptr(), m, h, h, m, 1, 0, 0, 0,
                        bf, stream), "tower_quantize_q8")
            ys.append(y)
        seq_l, nv, nv_p, l_p = 31, 7, 160, 40
        hp = -(-h // 8) * 8
        rows = torch.zeros(2, nv * seq_l, hp, dtype=x.dtype, device=dev)
        rows[..., :h] = x[:2 * nv * seq_l].view(2, nv * seq_l, h)
        for entry in (mine, parent["quantize_q8"]):
            y = torch.full((2, l_p, nv_p, h), 77, dtype=torch.int8,
                           device=dev)
            check(entry(rows.data_ptr(), y.data_ptr(), 2 * nv * seq_l, h, hp,
                        nv * seq_l, seq_l, nv_p, l_p, 3, bf, stream),
                  "tower_quantize_q8 (transposed)")
            ys.append(y)
        torch.cuda.synchronize()
        out[h] = {"in_place": torch.equal(ys[0], ys[1]),
                  "transposed": torch.equal(ys[2], ys[3])}
    return out


def compare(a_path: str, b_path: str) -> None:
    import torch

    a, b = torch.load(a_path), torch.load(b_path)
    for case in a:
        diffs = [float((x.float() - y.float()).abs().max())
                 for x, y in zip(a[case], b[case])]
        print(json.dumps({"compare": case, "max_abs_diff": max(diffs),
                          "bitwise": all(torch.equal(x, y) for x, y in
                                         zip(a[case], b[case]))}),
              flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="a checkout whose csrc/tower.cu is "
                    "built and timed beside this one's")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    args = ap.parse_args()
    if args.compare:
        compare(*args.compare)
        return
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")
    parent = parent_library(args.parent) if args.parent else None
    for dtype in ("bfloat16", "float32"):
        packed = _packed(dtype, dev)
        for kind, n, l, d in SHAPES:
            for rec in case_records(kind, n, l, d, dtype, packed[kind],
                                    parent):
                print(json.dumps(rec), flush=True)
        del packed
    from dldkd_tpu_torch.ops.kernels.query_tower import (
        q8_reciprocal_mismatches)

    start = time.perf_counter()
    print(json.dumps({"what": "q8 reciprocal, all 2^32 bf16 pairs",
                      "mismatches": q8_reciprocal_mismatches(dev),
                      "seconds": time.perf_counter() - start}), flush=True)
    for dtype in ("bfloat16", "float32"):
        for what, rows, transposed in Q8_CASES:
            print(json.dumps(q8_case(what, rows, transposed, dtype, dev,
                                     parent)), flush=True)
            torch.cuda.empty_cache()
        if parent is not None:
            print(json.dumps({"what": "q8 edge rows vs parent",
                              "dtype": dtype, "bitwise": q8_vs_parent_edges(
                                  dtype, dev, parent)}), flush=True)


if __name__ == "__main__":
    main()
