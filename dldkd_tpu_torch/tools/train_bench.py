"""Per-stage train-step benchmark on the card (port of
dldkd_tpu/tools/train_bench.py).

Times the train step of `train.train_step` whole and in stages, so work on
training speed can aim at the stage that costs:

  fwd        forward only: compute_losses in training mode, no autograd
  fwd+bwd    the same loss and its gradient for every parameter
  update     the global-norm clip and BertAdam on fixed gradients
  full       train.train_step, the shipped step

The workload is the JAX tool's (bench.py's training workload): 128 videos
of 128 frames at 1,024 dims with 512-dim teacher frames, 256 captions of
30 tokens at 768 dims (two per video), both branches at hidden 384 with 4
heads, soft labels, hard negatives from a pool of 20, BertAdam; random
weights and batch from fixed seeds. `--dtype` and `--stacked` are the
training flags `--dtype` and `--stacked_towers`. The float32 products
outside the bf16 towers (the losses', attention's probs @ v) run at
`--matmul_precision`: by default "highest" for float32 and "default"
(torch "medium": bf16 passes) for bfloat16, as the JAX tool does; the
trainer's own default is "highest" in both dtypes.

Each stage: one warm-up call, then `--reps` calls, each ended by a device
synchronize; the JSON reports each stage's median. The JAX tool's `--scan`
(the step as one lax.scan program) and `--cost` (XLA's cost analysis)
have no PyTorch counterpart. In their place the full step is traced once
with torch.profiler over PROFILE_STEPS steps: the device-busy time per
step (the union of the kernel, memcpy and memset spans) and the CUDA
kernels launched per step. Peak memory is the device's peak over the
full-step loop. `--rng` is accepted and does nothing (every stream comes
from one torch.Generator), as the trainer's --rng_impl.

Prints one JSON line. Runs on the card unless `--torch_device cpu`; on
the CPU the device numbers are null (a CPU clock measures no device).

Usage: python -m dldkd_tpu_torch.tools.train_bench [--reps 30]
           [--dtype float32|bfloat16] [--stacked]
           [--matmul_precision highest|high|default]
           [--torch_device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time
from typing import Dict, Optional

import torch

from dldkd_tpu_torch import float32_matmul_precision, resolve_device
from dldkd_tpu_torch.config import ModelConfig, TrainConfig
from dldkd_tpu_torch.models import DLDKD
from dldkd_tpu_torch.models.objective import LossScalars, compute_losses
from dldkd_tpu_torch.optim import BertAdam, default_wd_mask, schedules
from dldkd_tpu_torch.train import clip_grads, train_step

# bench.py's training shapes (L_FRAMES, D_STUDENT, D_QUERY, L_TOKENS) and
# the teacher width; 128 videos, two captions each
WORKLOAD = dict(bsz=128, captions_per_video=2, frames=128, d_video=1024,
                tokens=30, d_query=768, d_teacher=512, hidden=384,
                n_heads=4, hard_pool_size=20)
STAGES = ("fwd", "fwd+bwd", "update", "full")
PROFILE_STEPS = 3     # full steps traced for the device numbers


def make_batch(w: Dict[str, int], device) -> Dict[str, torch.Tensor]:
    """The benchmark batch (all frames and tokens valid), drawn on the
    CPU from seed 0 and moved to `device`."""
    g = torch.Generator().manual_seed(0)
    n_q = w["bsz"] * w["captions_per_video"]
    batch = {
        "student_videos": torch.randn(w["bsz"], w["frames"], w["d_video"],
                                      generator=g),
        "student_videos_mask": torch.ones(w["bsz"], w["frames"]),
        "teacher_videos": torch.randn(w["bsz"], w["frames"], w["d_teacher"],
                                      generator=g),
        "student_text": torch.randn(n_q, w["tokens"], w["d_query"],
                                    generator=g),
        "student_text_mask": torch.ones(n_q, w["tokens"]),
        "teacher_text": torch.randn(n_q, w["d_teacher"], generator=g),
        "text_labels": torch.arange(w["bsz"]).repeat_interleave(
            w["captions_per_video"]),
    }
    return {k: v.to(device) for k, v in batch.items()}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _median_ms(fn, reps: int, dev: torch.device) -> float:
    fn()
    _sync(dev)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def span_union(spans) -> float:
    """Length of the union of (start, end) spans, in the spans' unit."""
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def profile_step(step, n_steps: int) -> Dict[str, float]:
    """Device-busy ms and CUDA kernels per step of `step()`, run n_steps
    times under torch.profiler (a chrome trace parsed for its kernel,
    memcpy and memset events)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="train_bench_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans, kernels = [], 0
    for e in events:
        cat = e.get("cat")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e:
            spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
            kernels += cat == "kernel"
    if not kernels:
        raise RuntimeError("the profiler saw no CUDA kernel in the step")
    return {"device_busy_ms_per_step": span_union(spans) / 1e3 / n_steps,
            "kernels_per_step": kernels / n_steps}


def default_precision(dtype: str) -> str:
    """The JAX tool's matmul precision per dtype."""
    return "highest" if dtype == "float32" else "default"


class Setup:
    """The workload's model (seeded weights), BertAdam, batch, dropout
    generator and loss scalars for one setting, on `dev`; `step()` is one
    `train.train_step`."""

    def __init__(self, dtype: str, stacked: bool, precision: str,
                 dev: torch.device, w: Optional[Dict[str, int]] = None):
        w = w or WORKLOAD
        self.bsz = w["bsz"]
        self.mcfg = ModelConfig(
            visual_input_size=w["d_video"], query_input_size=w["d_query"],
            inheritance_hidden=w["hidden"], exploration_hidden=w["hidden"],
            max_ctx_l=w["frames"], max_desc_l=w["tokens"],
            n_heads=w["n_heads"], double_branch=True, label_style="soft",
            use_hard_negative=True, hard_pool_size=w["hard_pool_size"],
            dtype=dtype, matmul_precision=precision)
        self.tcfg = TrainConfig(stacked_towers=stacked)
        self.model = DLDKD(self.mcfg).init_weights(
            torch.Generator().manual_seed(1))
        self.model.to(dev).train()
        self.named = dict(self.model.named_parameters())
        self.opt = BertAdam(
            self.named, self.tcfg.lr,
            schedules.make_lr_schedule("warmup_linear", 0.01, 1e5),
            weight_decay=self.tcfg.wd, wd_mask=default_wd_mask(self.named))
        self.batch = make_batch(w, dev)
        self.gen = torch.Generator(device=dev).manual_seed(2)
        self.scalars = LossScalars(*(
            torch.tensor(v, dtype=torch.float32, device=dev)
            for v in (1.0, 0.8, 0.8)))

    def step(self) -> Dict[str, torch.Tensor]:
        return train_step(self.model, self.mcfg, self.tcfg, self.opt,
                          self.batch, self.gen, self.scalars)


def bench(dtype: str = "bfloat16", stacked: bool = False, reps: int = 30,
          device=None, matmul_precision: Optional[str] = None) -> dict:
    """The benchmark's record (the JSON line) for one setting;
    matmul_precision None picks the JAX tool's per dtype."""
    dev = resolve_device(device)
    w = WORKLOAD
    precision = matmul_precision or default_precision(dtype)
    st = Setup(dtype, stacked, precision, dev, w)
    model, mcfg, tcfg, opt, batch, gen, scalars = (
        st.model, st.mcfg, st.tcfg, st.opt, st.batch, st.gen, st.scalars)
    params = list(st.named.values())
    grads0 = []     # one fwd_bwd's gradients, for the update stage

    def fwd():
        with torch.no_grad():
            compute_losses(model, batch, gen, mcfg, tcfg, scalars)

    def fwd_bwd():
        loss, _ = compute_losses(model, batch, gen, mcfg, tcfg, scalars)
        return torch.autograd.grad(loss, params, allow_unused=True)

    def update():
        opt.step(clip_grads(grads0, tcfg.grad_clip))

    full = st.step
    stages = {}
    with float32_matmul_precision(precision):
        grads0.extend(torch.zeros_like(p) if g is None else g
                      for g, p in zip(fwd_bwd(), params))
        for name, fn in zip(STAGES, (fwd, fwd_bwd, update)):
            stages[name] = _median_ms(fn, reps, dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        stages["full"] = _median_ms(full, reps, dev)
        peak = (torch.cuda.max_memory_allocated(dev) / 1e9
                if dev.type == "cuda" else None)
        prof = (profile_step(full, PROFILE_STEPS) if dev.type == "cuda"
                else {"device_busy_ms_per_step": None,
                      "kernels_per_step": None})
    n_params = sum(p.numel() for p in params)
    return {"tool": "train_bench", "device": (
                torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu"),
            "dtype": dtype, "stacked": stacked,
            "matmul_precision": precision, "reps": reps,
            "bsz": w["bsz"], "params_m": n_params / 1e6,
            "stages_ms": stages, "step_ms_median": stages["full"],
            "samples_per_s": w["bsz"] / stages["full"] * 1e3,
            "peak_gb": peak, "profiled_steps": PROFILE_STEPS, **prof}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--stacked", action="store_true",
                    help="--stacked_towers (both branches' towers as one "
                         "stacked computation)")
    ap.add_argument("--matmul_precision", default=None,
                    choices=("highest", "high", "default"),
                    help="the float32 products' precision (default: "
                         "highest for float32, default for bfloat16)")
    ap.add_argument("--rng", default="threefry2x32",
                    choices=("threefry2x32", "rbg"),
                    help="accepted for the JAX tool's command lines; does "
                         "nothing here")
    ap.add_argument("--torch_device", default="cuda",
                    choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    rec = bench(args.dtype, args.stacked, args.reps, args.torch_device,
                args.matmul_precision)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
