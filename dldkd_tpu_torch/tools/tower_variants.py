#!/usr/bin/env python3
"""Variants of the port's tower kernels (dldkd_tpu_torch/csrc/tower_mma.cu)
timed beside the source as it is, on one CUDA card; and each tower
launch's device time by kernel.

Cases: the video tower (200 videos x 128 frames, 1024 -> 384) and the
query tower (50 and 256 queries x 30 tokens on the 32-token grid, 768 ->
384), both branches, 4 heads, in f32 and bf16: the chain alone
(`query_tower.tower_cuda`) on weights packed once, as the eval runs it.
For each case the base source's device time by kernel instance comes
first (torch.profiler over 10 chains). Each variant is the source with a
few lines replaced; it builds with the port's nvcc flags into
csrc/_build/variants/ and takes the place of the library for its turn.
Every case runs in turns base, variant, variant, base: the chain's time
(CUDA events over 20 chains) and its kernels' device time (torch.profiler
over 10). A variant that drops work gives wrong outputs by design: it
exists to show what a launch's time is made of.

Run it by path from the repository root (it imports the port of the
checkout it sits in, or of DIR with --tree):

    python3 dldkd_tpu_torch/tools/tower_variants.py [variant ...]  # all
    python3 dldkd_tpu_torch/tools/tower_variants.py --tree DIR     # by
                                          # kernel only, the port in DIR
    python3 dldkd_tpu_torch/tools/tower_variants.py --by-kernel    # by
                                          # kernel only, this checkout

--save FILE writes each case's outputs (torch.save, on the CPU), for
`tower_epilogues.py --compare` against another checkout's on the same
seeded inputs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# name: [(old line(s), new line(s)), ...]
VARIANTS = {
    # f32 with three ring stages (one block per SM) instead of two
    "f32_stages3": [("  static constexpr int STAGES = 2;",
                     "  static constexpr int STAGES = 3;")],
    # bf16 with two ring stages instead of three
    "bf16_stages2": [("  static constexpr int STAGES = 3;",
                      "  static constexpr int STAGES = 2;")],
    # f32 products on 64-row blocks (one warpgroup) instead of 128
    "f32_wg1": [("  if constexpr (P::SPLIT) {\n    return launch_gemm<P, 2>",
                 "  if constexpr (P::SPLIT) {\n    return launch_gemm<P, 1>")],
    # f32 products with their big.big term alone (the split still runs)
    "f32_1prod": [(
        "        wgmma_tf32(acc, desc(as + ks * 32), desc(b + ks * 32), !first);\n"
        "        wgmma_tf32(acc, desc(a + ks * 32), desc(bs + ks * 32), 1);\n"
        "        wgmma_tf32(acc, desc(a + ks * 32), desc(b + ks * 32), 1);",
        "        wgmma_tf32(acc, desc(a + ks * 32), desc(b + ks * 32), !first);")],
    # f32 products without the split pass (wrong outputs: small is stale)
    "f32_nosplit": [("      for (int o = tid * 16; o < STAGE; o += THREADS * 16) {",
                     "      for (int o = tid * 16; o < 0; o += THREADS * 16) {")],
    # the products' bf16 outputs rounded two values at a time
    "bf16_store_pairs": [(
        "  for (int j = 0; j < 16 / (int)sizeof(T); ++j) ov[j] = narrow<T>(v[j]);",
        "  for (int j = 0; j < 16 / (int)sizeof(T); j += 2) {\n"
        "    if constexpr (sizeof(T) == 4) {\n"
        "      ov[j] = narrow<T>(v[j]);\n"
        "      ov[j + 1] = narrow<T>(v[j + 1]);\n"
        "    } else {\n"
        "      *reinterpret_cast<__nv_bfloat162*>(ov + j) =\n"
        "          __floats2bfloat162_rn(v[j], v[j + 1]);\n"
        "    }\n"
        "  }")],
    # the whole-row products without their LayerNorm statistics (wrong
    # outputs: what the statistics cost)
    "rows_no_stats": [(
        "    for (int rl = rank + cl * warp; rl < rows; rl += cl * NWARPS) {\n"
        "      const T* x = row_of(rl, true);",
        "    for (int rl = rows; rl < rows; rl += cl * NWARPS) {\n"
        "      const T* x = row_of(rl, true);")],
    # f32 attention in key tiles of 64 instead of 32
    "attn_f32_keys64": [("  constexpr int KT = A::SPLIT ? 32 : TILE;",
                         "  constexpr int KT = A::SPLIT ? 64 : TILE;")],
}


def build_variants(build, names) -> dict:
    """{name: the variant's library}, one nvcc each, all at once."""
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = (build.CSRC / "tower_mma.cu").read_text()
        for old, new in VARIANTS[name]:
            if old not in src:
                raise SystemExit(f"{name}: the source no longer has {old!r}")
            src = src.replace(old, new)
        cu, so = out_dir / f"tower_{name}.cu", out_dir / f"libtower_{name}.so"
        cu.write_text(src)
        procs[name] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{text}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def cases(dev):
    """{case: the chain of one launch on its inputs, as a function}"""
    import torch

    from dldkd_tpu_torch.config import ModelConfig
    from dldkd_tpu_torch.models import DLDKD
    from dldkd_tpu_torch.ops.fast_eval import tower_weights
    from dldkd_tpu_torch.ops.kernels import query_tower as qt

    gen = torch.Generator().manual_seed(1)
    out = {}
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        cfg = ModelConfig(visual_input_size=1024, query_input_size=768,
                          inheritance_hidden=384, exploration_hidden=384,
                          max_ctx_l=128, max_desc_l=30, n_heads=4,
                          double_branch=True, dtype=dtype)
        model = DLDKD(cfg).init_weights(torch.Generator().manual_seed(2))
        tw = tower_weights(model.eval(), dev)
        for kind, n, l, lp, d in (("context", 200, 128, 128, 1024),
                                  ("query", 50, 30, 32, 768),
                                  ("query", 256, 30, 32, 768)):
            x = torch.randn(n, lp, d, generator=gen)
            x = (x / x.norm(dim=-1, keepdim=True)).to(dev)
            lengths = torch.randint(3, l + 1, (n,), generator=gen)
            mask = (torch.arange(lp)[None] < lengths[:, None]).float().to(dev)
            packed = tw["packed"][kind][0]
            out[f"{kind} {n} {dtype}"] = (
                lambda x=x, mask=mask, packed=packed, tdt=tdt, kind=kind,
                l=l: qt.tower_cuda(x, mask, packed, 4, tdt, kind,
                                   pos_rows=l))
    return out


def cuda_ms(fn, n: int = 20, warmup: int = 3) -> float:
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


def kernel_name(name: str) -> str:
    """A kernel instance's name without namespaces and parameters:
    'gemm_mma_kernel<Bf16, 2>'."""
    name = name.replace("(anonymous namespace)::", "")
    base, _, rest = name.partition("<")
    if not rest:
        return name.split(" (")[0]
    base = base.split()[-1].split("::")[-1]
    return f"{base}<{rest.split('>(')[0]}>"


def by_kernel(fn, n: int = 10) -> dict:
    """Device ms per chain of each kernel instance (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        out[kernel_name(e.name)] = out.get(kernel_name(e.name), 0.0) + (
            e.time_range.end - e.time_range.start) / n / 1e3
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*")
    ap.add_argument("--tree", default=ROOT,
                    help="the checkout whose port is timed (by kernel only "
                         "when it is not this one)")
    ap.add_argument("--by-kernel", action="store_true",
                    help="time the chains by kernel and run no variant")
    ap.add_argument("--save", help="torch.save each case's outputs here")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    from dldkd_tpu_torch.ops.kernels import build

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    base = build.load("tower_mma")
    launches = cases(dev)
    for case, fn in launches.items():
        kernels = by_kernel(fn)
        print(json.dumps({"tree": os.path.abspath(args.tree), "case": case,
                          "chain_ms": cuda_ms(fn),
                          "device_ms": sum(kernels.values()),
                          "device_ms_by_kernel": kernels}), flush=True)
    if args.save:
        torch.save({case: [t.cpu() for t in fn()]
                    for case, fn in launches.items()}, args.save)
    if args.by_kernel or os.path.abspath(args.tree) != ROOT:
        return
    names = args.variants or list(VARIANTS)
    libs = build_variants(build, names)

    def use(lib):
        build._LIBS["tower_mma"] = lib
        build._BOUND.clear()

    for name in names:
        for case, fn in launches.items():
            times = {}
            for turn, lib in (("base", base), ("variant", libs[name]),
                              ("variant2", libs[name]), ("base2", base)):
                use(lib)
                times[turn] = {"chain_ms": cuda_ms(fn),
                               "device_ms": sum(by_kernel(fn).values())}
            print(json.dumps({"variant": name, "case": case, "ms": times}),
                  flush=True)
    use(base)


if __name__ == "__main__":
    main()
