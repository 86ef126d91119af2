#!/usr/bin/env python3
"""Variants of the port's scoring kernel (dldkd_tpu_torch/csrc/sim_max_mma.cu)
timed beside the source as it is, on one CUDA card.

Each variant is the source with a few lines replaced; it builds with the
port's nvcc flags into csrc/_build/variants/ and takes the place of the
library for its turn. Every case (f32, exact and bf16 scoring, the eval's
50 queries and serving's 256 against TVR's 2,179 x 128 x 384 frames, C
entry alone, CUDA events over 50 launches) runs in turns: base, variant,
variant, base. A variant that drops work gives wrong scores by design: it
exists to show what a kernel's time is made of.

    python3 scripts/sim_max_variants.py [variant ...]   # default: all
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from dldkd_tpu_torch.ops.kernels import build, sim_max  # noqa: E402
from dldkd_tpu_torch.ops.masking import l2_normalize  # noqa: E402

_PRODUCTS = """        S::mma(acc, desc(sa + ks * 32), desc(b + ks * 32),
               st.kc > 0 || ks > 0);
        S::mma(acc, desc(a + ks * 32), desc(sb + ks * 32), 1);
        S::mma(acc, desc(a + ks * 32), desc(b + ks * 32), 1);"""

# name: [(old line(s), new line(s)), ...]
VARIANTS = {
    # exact with one or two of its three bf16 products per step
    "exact_1part": [("        for (int p = 0; p < 3; ++p)",
                     "        for (int p = 0; p < 1; ++p)")],
    "exact_2part": [("        for (int p = 0; p < 3; ++p)",
                     "        for (int p = 0; p < 2; ++p)")],
    # f32 with its big.big product alone, or without its split pass
    "f32_1prod": [(_PRODUCTS,
                   """        S::mma(acc, desc(a + ks * 32), desc(b + ks * 32),
               st.kc > 0 || ks > 0);""")],
    "f32_nosplit": [("for (int o = tid * 16; o < STAGE_BYTES;",
                     "for (int o = tid * 16; o < 0;")],
    # f32 above 64 queries on one-warpgroup blocks (two per SM)
    "f32_wg1": [("  if (nq > 64 && smem_bytes<S, 2>(D * S::ELEM) <= MAX_SMEM)",
                 "  if (nq > 64 && S::QUERY != Query::kStaged &&\n"
                 "      smem_bytes<S, 2>(D * S::ELEM) <= MAX_SMEM)")],
    # a fourth ring stage: three stages in flight instead of two
    "stages4": [("constexpr int STAGES = 3;", "constexpr int STAGES = 4;")],
    # four stages, two loaded ahead, one stage's products left in flight
    # while the next is waited for and issued (f32's single split scratch
    # makes its scores wrong here)
    "lag1": [("constexpr int STAGES = 3;", "constexpr int STAGES = 4;"),
             ("  for (int s = 0; s < STAGES - 1; ++s) {",
              "  for (int s = 0; s < STAGES - 2; ++s) {"),
             ("    cp_wait<STAGES - 2>();", "    cp_wait<STAGES - 3>();"),
             ("    if (i + STAGES - 1 < total) load_next();",
              "    if (i + STAGES - 2 < total) load_next();"),
             ("    wgmma_wait();  // before the slot is refilled and the "
              "epilogue reads",
              "    if (st.kc == nk - 1) wgmma_wait();\n"
              "    else asm volatile(\"wgmma.wait_group.sync.aligned 1;\\n\" "
              "::: \"memory\");")],
}


def build_variant(name: str) -> ctypes.CDLL:
    src = (build.CSRC / "sim_max_mma.cu").read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise SystemExit(f"{name}: the source no longer has {old!r}")
        src = src.replace(old, new)
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
    cu.write_text(src)
    r = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I",
                        str(build.CSRC), "-o", str(so), str(cu)],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{r.stdout}{r.stderr}")
    return ctypes.CDLL(str(so))


def use(lib: ctypes.CDLL) -> None:
    build._LIBS["sim_max_mma"] = lib
    build._BOUND.clear()


def cases(dev):
    """{case: a function that returns the C entry's launch on its inputs}"""
    gen = torch.Generator().manual_seed(0)
    nv, lf, h = 2179, 128, 384
    ctx = torch.randn(nv, lf, h, generator=gen).to(dev)
    mask = (torch.rand(nv, lf, generator=gen) < 0.9).float().to(dev)
    cn = l2_normalize(ctx).contiguous()
    c16 = (3 * ctx).to(torch.bfloat16)
    cb = cn.to(torch.bfloat16)
    inv, bias = sim_max.exact_frame_scales(c16, mask)
    out = {}
    for nq in (50, 256):
        qn = l2_normalize(torch.randn(nq, h, generator=gen).to(dev))
        qb = qn.to(torch.bfloat16)
        out[f"f32 {nq}"] = (lambda qn=qn: chip_smoke.scoring_launch(
            "sim_max_f32", qn, cn, mask))
        out[f"exact {nq}"] = (lambda qn=qn: chip_smoke.scoring_launch(
            "sim_max_exact", qn, c16, inv, bias))
        out[f"bf16 {nq}"] = (lambda qb=qb: chip_smoke.scoring_launch(
            "sim_max_bf16", qb, cb, mask))
    return out


def main(names) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    base = build.load("sim_max_mma")
    dev = torch.device("cuda")
    launches = cases(dev)
    for name in names:
        lib = build_variant(name)
        for case, make in launches.items():
            times = {}
            for turn, turn_lib in (("base", base), ("variant", lib),
                                   ("variant2", lib), ("base2", base)):
                use(turn_lib)
                times[turn] = chip_smoke.cuda_ms(make(), n=50)
            print(json.dumps({"variant": name, "case": case,
                              "ms": times}), flush=True)
    use(base)


if __name__ == "__main__":
    main(sys.argv[1:] or list(VARIANTS))
