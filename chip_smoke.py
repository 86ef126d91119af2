#!/usr/bin/env python3
"""Proof that the PyTorch port (`dldkd_tpu_torch`) runs on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit: `python3 chip_smoke.py`. It imports nothing of JAX or of the JAX
package. Phases, in order; any failure exits non-zero without the final
`ok` line:

1. the card: name, count, and nvidia-smi's name and power limit;
2. build every CUDA kernel of the port from csrc/ with nvcc (sm_90a), one
   nvcc per source, all at once, and print ptxas' register, spill and
   shared-memory summary;
3. each kernel, in f32 and bf16, plus the one-branch tower launch, at the
   per-launch shapes of a TVR test eval (scoring and the bf16 query tower
   also at serving's 256 queries), against its plain PyTorch version on
   the same inputs: max abs error against a stated tolerance, kernel and
   plain times (CUDA events, >= 20 launches after warm-up) and the least
   time the card could take (bytes over 3.35 TB/s or the operations the
   kernel runs over the peak rate of their arithmetic: f32 scoring and the
   f32 towers count their three TF32 products, exact rescoring its three
   bf16 products; beside the f32 towers' bound, `bound_ms_f32_fma` is the
   rule of the SIMT chain they replaced, one product at the f32 FMA rate);
   the scorers' kernel time is their C entry's
   alone, the wrapper's beside it; then the same for the int8 scoring
   kernel (50 and 256 queries), the exact-rescore kernel (256 queries),
   the towers' int8 epilogue (both launches, 200 videos, bitwise, with its
   device time and share of the bytes bound; then one launch a branch at
   the serving corpus's 2,179 x 128 frames, and the bf16 reciprocal's
   check over all 2^32 pairs of bf16 value and norm, which fails the run
   on any pair that differs from the divide), and the rates
   that set the stage-2 dense-versus-gather cost model. Beside each
   scorer, `product_ms` times the bare products at the same shapes
   (`torch.matmul`, `torch._int_mm`; for exact rescoring the three bf16
   products of the query's parts): a yardstick, not the same function (it
   writes every frame score, with no mask and no max), which the port
   never calls, and the launch's warpgroups and shared memory per block
   (ptxas reports only static shared memory); beside each tower,
   `product_ms` times its three (query) or four (video) products with
   `torch.matmul` at the launch's shapes in the tower dtype, without the
   normalization, LayerNorms, attention, pooling or epilogues. The towers'
   kernel time is the chain alone on weights packed once, as the eval and
   serving run it, with `device_ms` beside it: the chain's kernels alone
   (torch.profiler), without the host's time between launches; then the
   towers at the shapes the kernels once refused (sequences of 136 and 300
   rows, an input width of 44 with hidden 36 in 4 heads, one 256-dim head,
   and the ActivityNet and Charades input width of 1,024 at hidden 384),
   both kinds, both dtypes, against their plain versions (the query tower
   also on 136 tokens at the serving width, and at the query width of
   1,024 on the eval's 50 queries, through `_tower_check`); then
   the towers' LayerNorms and pooling in the whole-row products'
   epilogues (`phase_epilogues`, `tools/tower_epilogues.py`): each fused
   product against the same product without them, its rows against the
   plain LayerNorm and pooling of that product's rows, and
   `torch.nn.functional.layer_norm` on the same rows as the LayerNorm's
   yardstick (`library_ms`, never called by the port); then the int8
   epilogue's transposed write (`q8_transposed`, the rows padded into the
   TPU scoring layout (L_p, Nv_p, H)) at 2,048 videos in both dtypes,
   bitwise against its plain version, through the towers and alone, with
   its pad bias, timed beside the in-place epilogue on the same rows;
4. `dldkd_tpu_torch.infer.main` on a synthetic dataset at full feature
   widths, with a checkpoint written by the port's own writer: the bf16
   serving config and the f32 parity config, then `--score_quant`; and
   `dldkd_tpu_torch.serving.main` on the same dataset (.npz queries) on its
   three routes (exact, two-stage, int8-only); the native corpus packer on
   that dataset against the numpy path (its call count, the largest
   difference); then the serving CLI in fresh processes, `--save_index`
   without queries and `--load_index` with the .npz queries and no dataset
   flags, whose lines must be the in-process two-stage run's; between
   them, the paper's other entry points (`phase_entry_scripts`), each in
   a fresh process with no device flag: the f32 weights above pickled as
   the reference's model.ckpt (`module.` names, an EasyDict config),
   `python -m dldkd_tpu_torch.convert`, then scripts/torch/do_test.sh on
   the converted directory (parameters bitwise and model_cfg.json equal to
   the directly written checkpoint's, the same test metrics as
   `infer.main`); scripts/torch/do_activitynet.sh and do_charades.sh at
   their widths (video and query 1,024, hidden 384 x 2, 4 heads, 128
   frames, 30 tokens; 256 train, 100 val and 100 test synthetic videos, 2
   epochs), each followed by do_test.sh with the dataset's eval feature
   (Charades: trained on i3d_rgb_lgi, do_test.sh given an i3d directory
   of other data; the restored opt.json's feature must be read): finite
   losses, two validations, the best checkpoint, the script's flags in
   opt.json, the eval log's rows; then one validation of each trained
   checkpoint in this process through the f32 kernels (each launched, no
   plain version run) against the plain versions, ranks equal, and the
   run's best validation SumR reproduced;
5. the resident eval at TVR test-split scale (2,179 videos x 128
   frames, 10,895 queries, both branches), in bf16 and in f32: metrics,
   wall time, peak memory and launch counts; one more pass of each under
   torch.profiler (device time by kernel, device idle share); then the
   kernel path's score matrices and fused SumR against the plain path's
   (f32: SumR equal, and no SIMT product (`gemm_kernel`) in the profile;
   every profiled eval fails on a separate LayerNorm or pooling kernel,
   or on tower kernels other than 5 per query-tower launch, 6 per
   video-tower launch and 1 per int8 epilogue);
   then corpus streaming at the same scale (`phase_streaming`): each
   kernel at the streaming shapes against its plain version (the four
   scorers with all 10,895 queries against a 512-video block, timed also
   at 2,048; the dual video tower on a 2,048-video block in both dtypes
   and with its int8 epilogue; the dual query tower at 64 queries), the
   streaming eval in f32, bf16 and int8 at blocks of 512 and 2,048 (wall
   time, queries/s, peak memory, launches, a profile with the
   host-to-device copies and their overlap with kernels; scores and ranks
   against the resident engine's in the same call: f32 ranks and fused
   SumR equal, each stage's difference shown), `run_retrieval_eval` under
   a $DLDKD_EVAL_MEM_BUDGET below the resident estimate (it must stream in
   2,048-video blocks and give the resident metrics), and the raw-store
   `Retriever` on three routes at both blocks (bf16: one search of every
   query, queries/s, peak memory, each route against its plain path; f32:
   the exact route's ids against the encoded store's);
   then the bf16 int8 eval (score_quant) the same way, profiled too; then
   the serving `Retriever` at the same scale (query batch 256, k = 10) as
   exact, two-stage with dense and with gather stage 2, and int8-only:
   queries/s, per-batch p50/p99 latency, peak memory, launches, dense
   against gather, and each route against its plain path on the first 512
   queries; then index artifacts (`phase_artifacts`) of four stores
   (exact, two-stage, int8-only, raw at 2,048): index() against save_index
   and load_index seconds, bytes on disk, the loaded index's ids and scores
   over every query bitwise the builder's, the memory that keeping the
   exact store's unnormalized frames would add, a two-signature prewarm
   (the first search after load_index with and without the manifest, in
   turns), and the towers' transposed int8 emission of the whole corpus
   against the int8-only artifact's rows; then multi-GPU on one card
   (`phase_parallel`, `dldkd_tpu_torch/parallel/`): the corpus-sharded
   eval through run_retrieval_eval on a mesh of two shards on cuda:0
   (and over every GPU when there are several), resident bf16 and f32,
   streaming 512 bf16, resident and streaming int8, each against the
   single-device eval in turns (every metric equal, wall time, peak
   memory, launches; the score matrices against the single-device
   engine's at its query batch and at the mesh route's 64), the
   workload's one-branch twin sharded (the one-branch towers launch, one
   scorer launch per shard and query batch), `train.main` in this
   process as an NCCL world of one (torchrun's variables set by the
   phase: the data-parallel log line, finite losses, the checkpoint, the
   validation's and test inference's kernels on the process-group mesh;
   then its data-parallel step against the single-device step in turns,
   wall ms and device-busy ms), and two gloo ranks sharing cuda:0
   (`chip_smoke.py --dp-rank R PORT`, gloo takes CUDA tensors; NCCL
   refuses two ranks on one device): their data-parallel step at the
   train phase's widths, plain and stacked, against the single-device
   step (losses within rtol 2e-4, parameters within rtol 2e-4 + 1e-6,
   the ranks equal); then corpus-sharded serving (`phase_serving_mesh`,
   `Retriever(mesh=...)`) on a mesh of two shards on cuda:0 and on
   `make_mesh()` (every GPU; a mesh of one on one GPU), the bf16 serving
   model at TVR scale, batch 256, k 10: encoded exact, two-stage with
   DLDKD_DENSE_RESCORE pinned to always and to never, int8-only, and the
   raw store at block 2,048 exact, two-stage (dense) and int8-only, each
   against the single-device Retriever on the same route in turns (ids
   equal, scores within 1e-5 and whether bitwise, wall, queries/s, peak
   memory, the route's kernels launched with no plain version run,
   launches per search: scorers = batches (raw: blocks) x live shards x
   branches, query towers = batches), then against the same mesh with
   plain=True on 512 queries (within the bf16 scores' 3e-2); the one-branch
   twin on each mesh (one scorer launch per shard and batch); index
   artifacts of the exact, int8-only and raw stores built on the mesh and
   loaded on one device and the reverse (ids and scores bitwise); then
   the benches (`phase_benches`, `dldkd_tpu_torch/tools/`): in this
   process
   stage_bench (3 reps a stage; its one-branch rows launch the one-branch
   towers) and the port bench's whole line (`tools.bench.main`: the int8
   and exact evals at TVR scale, the three train keys, the replica fleet
   drill of coldstart_bench in subprocesses, streaming at 8x TVR), each
   with every kernel of its path launched, no plain version run and finite
   positive times, the line with bench.py's keys (vs_baseline null,
   train_speed null with its reason, the card's name and power limit),
   then the bench's int8 eval kernel against plain on 1,024 queries (every
   rank flip a near tie, C5); in fresh processes search_bench (its exact
   row's first-batch ids equal to Retriever.search's), stream_bench
   --scale 8 --reps 2 --host and coldstart_bench --policy cold (a fresh
   kernel-library directory: nvcc builds inside its time);
6. CLIP teacher extraction (`phase_teacher`): a model directory in the
   JAX tool's layout (config.json at openai/clip-vit-base-patch32's
   published widths, flax_model.msgpack of seeded weights written through
   `convert.clip_params_to_flax`, preprocessor_config.json at 224 / 224),
   a synthetic dataset with seeded uint8 .npy frame stacks (64 train
   videos x 32 frames at 240 x 320); `python -m
   dldkd_tpu_torch.tools.extract_teacher --feature_format npz` in both
   modes in fresh processes on the card; the stores (every caption and
   video, 512 wide, finite); both loops timed in this process (captions/s,
   images/s, the preprocess share, peak memory, the least time from the
   forward's operations at the f32 rate); the preprocessing on the card
   bitwise the CPU's; 16 captions' and 16 frames' features on the card,
   and the stores' rows, against the same model on the CPU (1e-4); then
   one `train.main --debug` epoch on the extracted 512-d stores (finite
   losses, the validation's kernels launched);
7. training (`dldkd_tpu_torch.train.main`) at do_tvr.sh's widths and
   hyperparameters on a synthetic dataset (.npz stores; 1,024 train
   videos, 8 steps of 128 per epoch, 500 val and 500 test videos):
   `--eval_untrained --n_epoch 2`, then `--resume` from the best
   checkpoint to epoch 3 under `--profile_dir` (5 steps). It fails on a
   non-finite loss, a kernel of the validation (both f32 towers, f32
   scoring) that never launched or a plain version that ran, a missing
   best checkpoint or test metrics, a resumed run that does not start at
   epoch 2. On the trained checkpoint: the validation's seconds, the
   kernel path's fused SumR against the plain path's (equal), the step's
   median time after the first step, samples/s and peak memory, the
   forward-and-losses and optimizer device time per step, device time by
   op class and the idle share over the 5 profiled steps, and one train
   step on the card against the same step on the CPU (dropout 0, hard
   negatives from a pool of 1: losses within 1e-4, the whole gradient
   within 1e-4 of its norm; the parameters after the step are
   reported), and the int8 eval of the trained checkpoint, kernel path
   against plain (scores within 3e-2, each rank flip of the ground truth
   listed with its plain-path gap, every one a near tie). Then
   `train.main --dtype bfloat16 --stacked_towers` for 2
   epochs: finite losses, its validations through the bf16 kernels (bf16
   scoring, both bf16 towers) with no plain call, a bf16 checkpoint; on
   it, one validation's launches, the kernel path's scores against the
   plain path's in bf16 (within 3e-2, every rank flip a near tie) and in
   int8 as for the f32 checkpoint, the
   stacked forward against the sequential one on the card (dropout off:
   1e-5 in f32, 3e-2 in bf16) and a bf16 stacked step on the card
   against the CPU's (loss_overall within rtol 1e-2, the update apart by
   less than its norm); then `dldkd_tpu_torch.tools.train_bench` in its
   four settings (f32 / bf16 x sequential / stacked) and bf16 stacked at
   matmul precision "highest", 8 reps a stage: stage medians, samples/s,
   device-busy ms and CUDA kernels per step, peak GB;
8. one JSON line listing every ported kernel; then the final `ok` line.

Each path runs with the launch counts set to 0 just before it and read
just after, and fails if a kernel of that path never launched. The counts
in the kernels line come from the path that runs each kernel: the bf16 TVR
eval (bf16 masked-cosine scoring, both towers), the f32 TVR eval (f32
masked-cosine scoring), the int8 eval (int8 scoring, the int8 epilogue)
and two-stage serving with dense stage 2 (exact rescoring); each kernel's
time there is the phase-3 time at that path's shapes (the eval's 50
queries, serving's 256). Each kernel also carries its check at the
streaming shapes (`streaming_check`) and its launches on each streaming
path (`streaming_launches`). Each kernel of the train phase's path (f32
scoring, both f32 towers) also carries its launches in train.main
(`train_launches`) and in one validation (`launches_per_validation`);
the bf16 ones (bf16 scoring, both bf16 towers) also in the bf16 stacked
train.main (`train_launches_bf16_stacked`) and in one bf16 validation
(`launches_per_bf16_validation`). The
epilogue's transposed write (`context_tower_q8_t`) is on no path of the
JAX package either; its launches are those of the artifact phase's
transposed emission of the corpus, its times the phase-3 check's at 2,048
videos. Each kernel also carries its launches on each in-process path of
`phase_benches` (`bench_launches`: stage_bench, the port bench); the
one-branch tower launches (`query_tower_1br`, `context_tower_1br`) have
entries of their own, their launches those of stage_bench's one-branch
rows and their times phase 3's one-branch bf16 checks. Each kernel that
`phase_parallel` or `phase_serving_mesh` ran also carries its launches
on each of those phases' paths (`parallel_launches`; the serving paths
named "serving <route>, <mesh>"). Each kernel that the in-process
validations of `phase_entry_scripts` ran (f32 scoring, both f32 towers)
also carries its launches there (`entry_launches`, by dataset).
"""

from __future__ import annotations

import json
import logging
import math
import os
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
PEAK_OPS = {"float32": 67e12,   # f32 outside the tensor cores
            "tf32": 495e12,     # dense TF32 tensor cores
            "bfloat16": 989e12,  # dense bf16 tensor cores
            "int8": 1979e12}     # dense int8 tensor cores
TVR = dict(n_videos=2179, n_queries=10895, frames=128, tokens=30,
           d_video=1024, d_query=768, hidden=384, heads=4,
           query_bsz=50, context_bsz=200)
# max abs error tolerances, kernel vs plain version on the same inputs
TOL = {
    # scores of unit vectors; f32: 3xTF32 tensor-core products, each
    # within ~2^-22 of the f32 product; bf16: tensor-core products, exact
    # in f32; sums in another order either way
    ("sim_max", "float32"): 1e-5, ("sim_max", "bfloat16"): 1e-5,
    # five chained products and three LayerNorms, f32 sums in another order
    ("tower", "float32"): 1e-4,
    # the same rounding points to bf16; another accumulation order flips a
    # rounding now and then, a few bf16 ulps of O(1) values
    ("tower", "bfloat16"): 3e-2,
    # the eval's scores: the towers' differences carried into cosines
    ("scores", "float32"): 1e-4, ("scores", "bfloat16"): 3e-2,
    # integer sums: valid-video scores bitwise
    ("sim_max_int8", "int8"): 0.0,
    # split-3 bf16 products of the f32 query and the bf16 frames, exact,
    # summed in another order than the plain version's f32 matmul
    ("sim_max_exact", "float32"): 5e-6,
    # the epilogue's plain version sums in the kernel's order: bitwise
    ("context_tower_q8", "float32"): 0.0,
    ("context_tower_q8", "bfloat16"): 0.0,
    # exact rescores by the dense kernel and by the gather, ~1e-6 apart
    ("dense_vs_gather", "scores"): 1e-5,
    # the teacher's CLIP features, card vs CPU: twelve f32 layers at matmul
    # precision "highest" on both, sums in another order; features O(1)
    ("clip", "float32"): 1e-4,
}
SERVE = dict(query_bsz=256, k=10, plain_queries=512, shortlist=40)
# corpus streaming: the streaming eval's and the raw store's corpus blocks,
# the streaming eval's query batch (run_retrieval_eval's, at least 64) and
# the block at which the scorers are held against their plain versions
STREAM = dict(blocks=(512, 2048), query_bsz=64, check_block=512)
# the ActivityNet and Charades scripts' datasets: the I3D width of their
# public features and their query width (1,024 both), 128 frames, 30
# tokens, CLIP's 512-wide teacher; small splits, two epochs; the models at
# the scripts' widths (hidden 384 x 2, 4 heads: the flags' defaults)
ENTRY = dict(n_train=256, n_val=100, n_test=100, d_video=1024, d_query=1024,
             d_teacher=512, noise=6.0, n_epoch=2)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check_no_jax() -> None:
    if any(m.split(".")[0] in ("jax", "jaxlib", "flax", "dldkd_tpu")
           for m in sys.modules):
        fail("JAX or the JAX package was imported")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, n: int = 25, warmup: int = 3) -> float:
    """Mean device time of fn() over n back-to-back calls, CUDA events."""
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


def device_ms(fn, n: int = 10) -> float:
    """Device time of fn() per call: the kernels' and copies' durations in
    torch.profiler's trace of n calls, summed. Unlike cuda_ms it leaves out
    the host's time between launches, which sets cuda_ms for a chain of
    small kernels."""
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


def bound(n_bytes: float, n_ops: float, arith: str):
    """The least time for the work: n_bytes over the memory rate or the
    n_ops the kernel runs over the peak rate of its arithmetic, the larger,
    and which of the two it is."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[arith] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def eval_at(model, videos, queries, dev, query_bsz: int,
            context_bsz: int = 200, score_quant: bool = False,
            stream: int = 0) -> dict:
    """One eval's metric dicts at explicit batch sizes
    (`evaluate.run_retrieval_eval` takes them from its route): the
    resident engine in context batches of context_bsz, or with stream > 0
    the streaming one in corpus blocks of stream, then the eval's metric
    tail."""
    from dldkd_tpu_torch import evaluate

    if stream:
        scores = evaluate.stream_score_matrices(
            model, videos, queries, stream, query_bsz, dev, score_quant)
    else:
        scores = evaluate.score_matrices(model, videos, queries, context_bsz,
                                         query_bsz, dev,
                                         score_quant=score_quant)
    return evaluate._metrics_from_score_matrices(
        *scores, evaluate._gt_on_device(queries, videos, dev), (0.7, 0.3))


def scoring_launch(symbol: str, q, ctx, *per_frame):
    """A scoring kernel alone: its C entry in csrc/sim_max_mma.cu called on
    prepared CUDA tensors without the wrapper's checks and bookkeeping, so
    that its time is the kernel's (the wrapper's is timed beside it).
    Counts no launch."""
    import torch

    from dldkd_tpu_torch.ops.kernels.build import bind

    fn = bind("sim_max_mma", symbol, 3 + len(per_frame), 4)
    nq, d = q.shape
    nv, l_frames, _ = ctx.shape
    out = torch.empty((nq, nv), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), ctx.data_ptr(),
            *(t.data_ptr() for t in per_frame), out.data_ptr(), nq, nv,
            l_frames, d,
            torch.cuda.current_stream().cuda_stream)
    return lambda: fn(*args)


# ------------------------------------------------------------------ phases

def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a GPU")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit({"phase": "device", "kind": name, "count": count,
          "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    # the plain versions are the references: true f32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return name, count, card


def phase_build():
    from dldkd_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    libs = build.build()
    secs = time.perf_counter() - t0
    for name in libs:
        fn = None
        for line in build.log_path(name).read_text().splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif fn and ("registers" in line or "spill" in line):
                print(f"ptxas {name} {fn}: {line.strip()}", flush=True)
    emit({"phase": "build", "seconds": secs,
          "libraries": {k: str(v) for k, v in libs.items()}})


def _serving_model(dtype: str, seed: int, tokens: int = TVR["tokens"],
                   d_query: int = TVR["d_query"]):
    import torch

    from dldkd_tpu_torch.config import ModelConfig
    from dldkd_tpu_torch.models import DLDKD

    cfg = ModelConfig(visual_input_size=TVR["d_video"],
                      query_input_size=d_query,
                      inheritance_hidden=TVR["hidden"],
                      exploration_hidden=TVR["hidden"],
                      max_ctx_l=TVR["frames"], max_desc_l=tokens,
                      n_heads=TVR["heads"], double_branch=True, dtype=dtype)
    model = DLDKD(cfg).init_weights(torch.Generator().manual_seed(seed))
    return model.eval()


def _ragged_mask(n: int, l: int, low: int, gen, dev):
    import torch

    lengths = torch.randint(low, l + 1, (n,), generator=gen)
    mask = (torch.arange(l)[None, :] < lengths[:, None]).float()
    mask[-1] = 0.0            # a padding row: all masked, must stay finite
    return mask.to(dev)


def _tower_flops(n: int, l: int, d: int, h: int, kind: str) -> float:
    m = n * l
    f = 2 * m * d * h + 3 * 2 * m * h * h + 2 * 2 * n * l * l * h \
        + 2 * m * h * h
    return f + (2 * m * h if kind == "query" else 2 * m * h * h)


def _tower_products(n, l, d, h, branches, kind, dtype, gen, dev):
    """The tower's products alone, torch.matmul at the launch's shapes: a
    yardstick the port never calls."""
    import torch

    m = n * l

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(dev, dtype)

    x, wp = rand(m, d), rand(d, branches * h)
    hb, wqkv, wo = rand(branches, m, h), rand(branches, h, 3 * h), \
        rand(branches, h, h)

    def run():
        torch.matmul(x, wp)
        torch.matmul(hb, wqkv)
        torch.matmul(hb, wo)
        if kind == "context":
            torch.matmul(hb, wo)
    return run


def _mma_smem(l: int, h: int, heads: int, dtype: str,
              kind: str = "context") -> dict:
    """Dynamic shared memory per block of csrc/tower_mma.cu's kernels at a
    launch's shapes (their launchers' formulas): the GEMM's 1 KB of
    alignment slack and a ring of (64 or 128 rows + 128 columns) x 128
    bytes a tile, 3 stages in bf16, 2 stages and a tile for a stage's small
    TF32 parts in f32; the whole-row products' blocks add their rows'
    statistics (8 bytes a row), pooling (query) the block's logits (its
    rows or L floats) and a warp's staging row of the branch's padded
    width where it does not fit the ring beside the row tile;
    attention's query tile (32 rows up to L = 32, else 128, or 64 above 128
    dims per head) and K and V key tiles (bf16 as the query tile, f32 32
    rows), each at most L rounded to 16 rows of the head's depth (bf16:
    dims padded to 16; f32: to 8) plus 16 bytes, and the key tile's
    biases."""
    def r(v, m):
        return -(-v // m) * m

    f32 = dtype == "float32"
    elem, tiles = (4, 3) if f32 else (2, 3)
    dh = r(h // heads, 8)
    depth = dh if f32 else r(dh, 16)
    tile = 32 if l <= 32 else (64 if depth > 128 else 128)
    keys = 32 if f32 else tile
    ld = (depth + 16 // elem) * elem
    def rows(bm):  # csrc/tower_mma.cu, rows_smem
        ring = tiles * (bm + 128) * 128
        stage = bm // 16 * r(h, 8) * elem
        fits = stage <= ring - bm * 136 * elem
        return (1024 + ring + 8 * bm
                + (4 * r(max(bm, l), 4) if kind == "query" else 0)
                + (0 if fits else stage))

    return {"gemm_64_rows": 1024 + tiles * (64 + 128) * 128,
            "gemm_128_rows": 1024 + tiles * (128 + 128) * 128,
            "gemm_rows_64_rows": rows(64), "gemm_rows_128_rows": rows(128),
            "attention": (min(tile, r(l, 16)) + 2 * min(keys, r(l, 16))) * ld
            + keys * 4}


def _scoring_smem(kind: str, nq: int, d: int) -> dict:
    """Warpgroups per block and dynamic shared memory per block of
    csrc/sim_max_mma.cu's launch at these shapes (its smem_bytes and
    launch()): resident query tiles (one, or three split parts for exact,
    none for f32), a 3-stage ring of 128 frames x 128 bytes (plus the
    queries' slice for f32), f32's split scratch, the per-frame values."""
    elem = {"float32": 4, "bfloat16": 2, "int8": 1, "exact": 2}[kind]
    nk = -(-d * elem // 128)

    def smem(wg):
        parts = {"float32": 0, "exact": 3}.get(kind, 1)
        stage = 128 * 128 + (wg * 64 * 128 if kind == "float32" else 0)
        scratch = stage if kind == "float32" else 0
        frames = 2 if kind == "exact" else 1
        return (1024 + parts * nk * 64 * wg * 128 + 3 * stage + scratch
                + 3 * frames * 128 * 4)

    wg = 2 if nq > 64 and smem(2) <= 232448 else 1
    return {"warpgroups": wg, "bytes": smem(wg)}


def _tower_check(kind, dtype, branches, shape, lp, packed, run, plain,
                 chain, n_plain=20, **extra) -> dict:
    """One tower launch of `branches` branches on x of `shape` (n, l, d),
    padded to lp rows, against its plain version: run() and plain() give
    the wrapper's and the plain version's outputs, chain() the CUDA chain
    alone (`tower_cuda` on the prepared inputs). Emits and returns its
    record (largest difference, the chain's time, also on the device, the
    wrapper's, the plain version's, the bound at these shapes, and
    `extra`); fails on a non-finite output or a difference past
    TOL[("tower", dtype)]."""
    import torch

    n, l, d = shape
    h = TVR["hidden"]
    f32 = dtype == "float32"
    item = torch.tensor([], dtype=getattr(torch, dtype)).element_size()
    got, want = run(), plain()
    torch.cuda.synchronize()
    err = max(max_err(a, b) for a, b in zip(got, want))
    finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
    del got, want
    tol = TOL[("tower", dtype)]
    w_bytes = sum(t.numel() * t.element_size() for t in packed.values())
    out_item = 4 if kind == "query" else item
    out_n = n * h if kind == "query" else n * l * h
    n_bytes = (n * lp * d * 4 + n * lp * 4 + w_bytes
               + branches * out_n * out_item)
    flops = branches * _tower_flops(n, lp, d, h, kind)
    # f32: three TF32 products (3xTF32); bf16: one
    b_ms, b_by = bound(n_bytes, (3 if f32 else 1) * flops,
                       "tf32" if f32 else dtype)
    name = f"{kind}_tower"
    rec = {"check": name, "dtype": dtype, "branches": branches,
           "shape": {"x": [n, l, d], "hidden": h},
           "max_abs_err": err, "tol": tol, "finite": finite,
           "kernel_ms": cuda_ms(chain), "device_ms": device_ms(chain),
           "wrapper_ms": cuda_ms(run), "plain_ms": cuda_ms(plain, n=n_plain),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, **extra,
           "mma_smem_bytes": _mma_smem(lp, h, TVR["heads"], dtype, kind)}
    if f32:  # the replaced SIMT chain's rule
        rec["bound_ms_f32_fma"] = bound(n_bytes, flops, "float32")[0]
    emit(rec)
    if not finite:
        fail(f"{name} {dtype} x{branches} n={n}: non-finite output")
    if not err <= tol:
        fail(f"{name} {dtype} x{branches} n={n}: max abs error {err} > "
             f"{tol}")
    return rec


def phase_kernels(dev):
    """Each kernel against its plain version at the per-launch shapes."""
    import torch

    from dldkd_tpu_torch.ops.fast_eval import tower_weights
    from dldkd_tpu_torch.ops.kernels import query_tower as qt
    from dldkd_tpu_torch.ops.kernels import sim_max
    from dldkd_tpu_torch.ops.masking import l2_normalize

    gen = torch.Generator().manual_seed(1)
    results = {}
    nv, lf, h = TVR["n_videos"], TVR["frames"], TVR["hidden"]
    nq = TVR["query_bsz"]
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        item = torch.tensor([], dtype=tdt).element_size()
        # ---- kernel 1: scoring, one branch, the eval's 50 queries and the
        # exact serving route's 256 x the corpus
        ctx = torch.randn(nv, lf, h, generator=gen).to(dev, tdt)
        mask = _ragged_mask(nv, lf, 8, gen, dev)
        cn = l2_normalize(ctx).contiguous()
        del ctx
        for n_q in (nq, SERVE["query_bsz"]):
            q = torch.randn(n_q, h, generator=gen).to(dev, tdt)
            qn = l2_normalize(q).contiguous()
            got = sim_max.fused_clip_scores(qn, cn, mask)
            want = sim_max.sim_max_plain(qn, cn, mask)
            torch.cuda.synchronize()
            err = max_err(got, want)
            tol = TOL[("sim_max", dtype)]
            n_bytes = ((n_q * h + nv * lf * h) * item + nv * lf * 4
                       + n_q * nv * 4)
            # f32: three TF32 products (3xTF32); bf16: one
            b_ms, b_by = bound(n_bytes, (3 if dtype == "float32" else 1)
                               * 2 * n_q * nv * lf * h,
                               "tf32" if dtype == "float32" else dtype)
            c2 = cn.view(nv * lf, h)
            entry = ("sim_max_f32" if dtype == "float32"
                     else "sim_max_bf16")
            rec = {"check": "sim_max", "dtype": dtype,
                   "shape": {"q": [n_q, h], "ctx": [nv, lf, h]},
                   "max_abs_err": err, "tol": tol,
                   "kernel_ms": cuda_ms(scoring_launch(entry, qn, cn,
                                                       mask)),
                   "wrapper_ms": cuda_ms(lambda: sim_max.fused_clip_scores(
                       qn, cn, mask)),
                   "plain_ms": cuda_ms(lambda: sim_max.sim_max_plain(
                       qn, cn, mask)),
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                   # yardstick only: the bare product, every frame score
                   # written, no mask, no max
                   "product_ms": cuda_ms(lambda: torch.matmul(qn, c2.t())),
                   "smem": _scoring_smem(dtype, n_q, h)}
            emit(rec)
            results[("sim_max", dtype) if n_q == nq
                    else ("sim_max", dtype, n_q)] = rec
            if not err <= tol:
                fail(f"sim_max {dtype} nq={n_q}: max abs error {err} > "
                     f"{tol}")
            del q, qn, got, want
        del cn

        # ---- kernels 2 and 3: the towers, both branches and one branch;
        # in bf16 the query tower also at serving's 256 queries; then the
        # query tower on 136 tokens (a model with that positional table),
        # whose pooling walks three 64-row tiles of each query
        model = _serving_model(dtype, seed=2)
        ws = tower_weights(model, dev)
        ws136 = tower_weights(_serving_model(dtype, seed=2, tokens=136), dev)
        ws1024 = tower_weights(_serving_model(dtype, seed=2,
                                              d_query=ENTRY["d_query"]), dev)
        cases = [("query", nq, TVR["tokens"], TVR["d_query"], ws, (2, 1)),
                 ("context", TVR["context_bsz"], lf, TVR["d_video"], ws,
                  (2, 1)),
                 ("query", nq, 136, TVR["d_query"], ws136, (2,)),
                 ("query", nq, TVR["tokens"], ENTRY["d_query"], ws1024,
                  (2,))]
        if dtype == "bfloat16":
            cases.insert(1, ("query", SERVE["query_bsz"], TVR["tokens"],
                             TVR["d_query"], ws, (2, 1)))
        for kind, n, l, d, ws, branch_counts in cases:
            x = torch.randn(n, l, d, generator=gen)
            x = (x / x.norm(dim=-1, keepdim=True)).to(dev)
            xm = _ragged_mask(n, l, 3, gen, dev)
            for branches in branch_counts:
                w = ws[kind][:branches]
                packed = qt.pack_weights(w, tdt, TVR["heads"], dev)
                if kind == "query":
                    lp = -(-l // 8) * 8
                    xp = torch.nn.functional.pad(x, (0, 0, 0, lp - l))
                    mp = torch.nn.functional.pad(xm, (0, lp - l))
                    run = (lambda: qt.query_towers(
                        x, xm, w, TVR["heads"], tdt, l, "check",
                        packed=packed))
                    plain = (lambda: qt.query_towers(
                        x, xm, w, TVR["heads"], tdt, l, "check",
                        plain=True))
                else:
                    lp, xp, mp = l, x, xm
                    run = (lambda: qt.context_towers(
                        x, xm, w, TVR["heads"], tdt, "check",
                        packed=packed))
                    plain = (lambda: qt.context_towers(
                        x, xm, w, TVR["heads"], tdt, "check", plain=True))
                chain = (lambda: qt.tower_cuda(xp, mp, packed, TVR["heads"],
                                               tdt, kind, pos_rows=l))
                rec = _tower_check(
                    kind, dtype, branches, (n, l, d), lp, packed, run, plain,
                    chain,
                    # yardstick only: the products alone, torch.matmul
                    product_ms=cuda_ms(_tower_products(
                        n, lp, d, h, branches, kind, tdt, gen, dev)))
                key = (rec["check"], dtype, branches)
                if n == SERVE["query_bsz"]:
                    key += (n,)
                elif l == 136:
                    key += ("L136",)
                elif d == ENTRY["d_query"] and kind == "query":
                    key += ("d1024",)
                results[key] = rec
        del model, ws, ws136, ws1024
        torch.cuda.empty_cache()
    return results


# (L, input width, hidden, heads) the tower kernels once refused: two and
# three key tiles, widths that are not multiples of 8 (4 heads of 9 dims),
# one 256-dim head; and the ActivityNet and Charades query width (1,024)
# at the serving model's hidden size
TOWER_SHAPES = ((136, 64, 32, 4), (300, 64, 32, 4), (20, 44, 36, 4),
                (20, 48, 256, 1), (30, 1024, 384, 4))


def phase_tower_shapes(dev):
    """Both towers, two branches, both dtypes, at TOWER_SHAPES on a few
    sequences, through the kernels, against their plain versions."""
    import torch

    from dldkd_tpu_torch.config import ModelConfig
    from dldkd_tpu_torch.models import DLDKD
    from dldkd_tpu_torch.ops.fast_eval import tower_weights
    from dldkd_tpu_torch.ops.kernels import query_tower as qt

    gen = torch.Generator().manual_seed(13)
    for l, d, h, heads in TOWER_SHAPES:
        for dtype in ("float32", "bfloat16"):
            tdt = getattr(torch, dtype)
            cfg = ModelConfig(visual_input_size=d, query_input_size=d,
                              inheritance_hidden=h, exploration_hidden=h,
                              max_ctx_l=l, max_desc_l=l, n_heads=heads,
                              double_branch=True, dtype=dtype)
            model = DLDKD(cfg).init_weights(
                torch.Generator().manual_seed(14)).eval()
            tw = tower_weights(model, dev)
            x = torch.randn(5, l, d, generator=gen).to(dev)
            xm = _ragged_mask(5, l, 3, gen, dev)
            for kind in ("query", "context"):
                ws, packed = tw[kind], tw["packed"][kind][0]
                before = _counts()[f"{kind}_tower"]
                if kind == "query":
                    got = qt.query_towers(x, xm, ws, heads, tdt, l, "check",
                                          packed=packed)
                    want = qt.query_towers(x, xm, ws, heads, tdt, l, "check",
                                           plain=True)
                else:
                    got = qt.context_towers(x, xm, ws, heads, tdt, "check",
                                            packed=packed)
                    want = qt.context_towers(x, xm, ws, heads, tdt, "check",
                                             plain=True)
                torch.cuda.synchronize()
                launched = _counts()[f"{kind}_tower"] - before
                err = max(max_err(a, b) for a, b in zip(got, want))
                finite = all(bool(torch.isfinite(a.float()).all())
                             for a in got)
                tol = TOL[("tower", dtype)]
                emit({"check": "tower_shapes", "kind": kind, "dtype": dtype,
                      "shape": {"L": l, "d": d, "hidden": h, "heads": heads,
                                "n": 5},
                      "launches": launched, "max_abs_err": err, "tol": tol,
                      "finite": finite})
                if launched != 1 or not finite or not err <= tol:
                    fail(f"{kind} tower {dtype} at L={l} d={d} hidden={h} "
                         f"heads={heads}: {launched} launches, max abs error "
                         f"{err} (tol {tol}), finite {finite}")
            del model, tw
    torch.cuda.empty_cache()


def phase_epilogues(dev) -> dict:
    """The towers' LayerNorms and pooling in the whole-row products'
    epilogues (`tools/tower_epilogues.py`), per launch at the eval's and
    serving's shapes in both dtypes: each fused product (`tower_gemm_ln`)
    timed against the same product without them (`tower_gemm_mma`), their
    difference the epilogue's cost; its rows against the plain LayerNorm
    and pooling of the plain product's rows (every value within one
    rounding of the tower dtype: `tower_epilogues.ROUNDING`); one
    `torch.nn.functional.layer_norm` on the same rows as the LayerNorm's
    yardstick and the bytes bound of a separate LayerNorm pass. Returns
    {(kind, n, dtype): records}."""
    import torch

    from dldkd_tpu_torch.tools import tower_epilogues as te

    out = {}
    for dtype in ("bfloat16", "float32"):
        packed = te._packed(dtype, dev)
        for kind, n, l, d in te.SHAPES:
            recs = te.case_records(kind, n, l, d, dtype, packed[kind])
            for rec in recs:
                emit({"check": "tower_epilogue", **rec})
                if "vs_plain" in rec \
                        and not rec["vs_plain"]["within_one_rounding"]:
                    fail(f"tower epilogue {rec['what']} {kind} {n} {dtype}: "
                         f"{rec['vs_plain']} against the plain version")
            out[(kind, n, dtype)] = recs
        del packed
    torch.cuda.empty_cache()
    return out


def _epilogue_brief(recs) -> dict:
    """The step-1 rows of one tower launch for the kernels line: per fused
    product its time with and without the epilogue (CUDA events and device
    time), and the LayerNorm's yardstick and bound."""
    proj, outp, ln = recs[:3]
    keep = ("gemm_mma", "gemm_ln", "epilogue_ms", "epilogue_device_ms",
            "vs_plain")
    return {"projection_layernorm": {k: proj[k] for k in keep},
            "output_layernorm" + ("_pool" if proj["kind"] == "query"
                                  else ""): {k: outp[k] for k in keep},
            "layernorm_library_ms": ln["library_ms"],
            "layernorm_pass_bound_ms": ln["bound_ms"]}


def _write_run(run_dir: str, root: str, dtype: str, seed: int) -> None:
    """opt.json, ckpt/model_cfg.json and a seeded-init ckpt/model.ckpt in
    the JAX package's formats, written by the port's own writers."""
    import dataclasses
    import os

    import numpy as np

    from dldkd_tpu_torch import checkpoint as ckpt_lib
    from dldkd_tpu_torch.config import Config
    from dldkd_tpu_torch.convert import params_from_state_dict

    model = _serving_model(dtype, seed)
    cfg = Config()
    cfg = dataclasses.replace(
        cfg, model=model.config,
        data=dataclasses.replace(cfg.data, root_path=root,
                                 collection="synthetic",
                                 visual_feature="i3d",
                                 q_feat_size=TVR["d_query"],
                                 max_ctx_l=TVR["frames"],
                                 max_desc_l=TVR["tokens"]))
    os.makedirs(run_dir, exist_ok=True)
    cfg.save(os.path.join(run_dir, "opt.json"))
    ckpt_lib.save_checkpoint(
        os.path.join(run_dir, "ckpt"),
        {"params": params_from_state_dict(model.state_dict()),
         "opt_state": {}, "epoch": 0, "best_score": 0.0,
         "rng": np.zeros(2, np.uint32)}, model.config)


def _counts():
    from dldkd_tpu_torch.ops.kernels import query_tower, sim_max

    return {**sim_max.LAUNCHES, **query_tower.LAUNCHES}


def _check_launched(counts, names, what: str) -> None:
    """Fail unless every kernel of the path launched in its run."""
    missing = [n for n in names if counts.get(n, 0) <= 0]
    if missing:
        fail(f"{what}: kernels of the path never launched: {missing} "
             f"({counts})")


EVAL_KERNELS = ("sim_max", "query_tower", "context_tower")


def _eval_kernels(dtype: str):
    """EVAL_KERNELS' counters of one dtype (the wrappers count each launch
    under the kernel's name and under its name and dtype)."""
    suffix = {"bfloat16": "bf16", "float32": "f32"}[dtype]
    return tuple(f"{k}_{suffix}" for k in EVAL_KERNELS)


INT8_EVAL_KERNELS = ("sim_max_int8", "query_tower", "context_tower",
                     "context_tower_q8")


def _reset_counts():
    from dldkd_tpu_torch.ops.kernels import query_tower, sim_max

    for table in (sim_max.LAUNCHES, query_tower.LAUNCHES):
        for k in table:
            table[k] = 0


def _check_metrics(metrics, what: str) -> None:
    if set(metrics) != {"inher", "explore", "fused"}:
        fail(f"{what}: metric keys {sorted(metrics)}")
    for branch, m in metrics.items():
        if not all(math.isfinite(v) for v in m.values()) \
                or not 0.0 <= m["sumr"] <= 400.0:
            fail(f"{what}: bad {branch} metrics {m}")


# the seed of phase_infer's weights (run_<dtype>/ckpt)
INFER_SEED = 4


def phase_infer(workdir: str):
    """The do_test.sh path through dldkd_tpu_torch.infer.main."""
    import os

    from dldkd_tpu_torch import infer
    from dldkd_tpu_torch.data.synthetic import generate_dataset

    root = os.path.join(workdir, "data")
    t0 = time.perf_counter()
    generate_dataset(root, n_videos={"test": 300}, frames_range=(20, 200),
                     tokens_range=(5, 31), d_student=TVR["d_video"],
                     d_query=TVR["d_query"], d_teacher=16, seed=3,
                     feature_format="npz")
    setup_s = time.perf_counter() - t0
    for dtype in ("bfloat16", "float32"):
        run_dir = os.path.join(workdir, f"run_{dtype}")
        _write_run(run_dir, root, dtype, seed=INFER_SEED)
        _reset_counts()
        t0 = time.perf_counter()
        metrics = infer.main(["--model_dir", run_dir, "--root_path", root,
                              "--torch_device", "cuda"])
        secs = time.perf_counter() - t0
        counts = _counts()
        emit({"phase": "infer.main", "dtype": dtype, "videos": 300,
              "dataset_setup_s": setup_s, "seconds": secs,
              "launches": counts, "metrics": metrics})
        _check_metrics(metrics, f"infer.main {dtype}")
        _check_launched(counts, _eval_kernels(dtype), f"infer.main {dtype}")
    return root


# (script, collection, training feature, do_test.sh's feature, seeds of
# the two feature directories, the script's own flags as opt.json keeps
# them); Charades trains on i3d_rgb_lgi and do_test.sh is given i3d, a
# directory of other data: the restored opt.json's feature must win
ENTRY_SCRIPTS = (
    ("do_activitynet.sh", "activitynet", "i3d", "i3d", (21, 21),
     {"exp_id": "ac_DLDKD++", "drop": 0.25, "input_drop": 0.25,
      "lr": 2.5e-4}),
    ("do_charades.sh", "charades", "i3d_rgb_lgi", "i3d", (22, 23),
     {"exp_id": "charades_DLDKD++", "drop": 0.15, "input_drop": 0.15,
      "lr": 0.00024}),
)


def _script_env(workdir: str) -> dict:
    """The environment for scripts/torch/*.sh: `python` on PATH is this
    interpreter."""
    bindir = os.path.join(workdir, "python_bin")
    os.makedirs(bindir, exist_ok=True)
    with open(os.path.join(bindir, "python"), "w") as f:
        f.write(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    os.chmod(os.path.join(bindir, "python"), 0o755)
    return dict(os.environ, PATH=f"{bindir}:{os.environ.get('PATH', '')}")


def _fresh(cmd, env, what: str) -> float:
    """cmd in a fresh process from the repository root; its wall seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=600, env=env,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        fail(f"{what}: exit {proc.returncode}: {proc.stderr[-2500:]}")
    return time.perf_counter() - t0


def _script(name: str, args, env) -> float:
    return _fresh(["bash", os.path.join("scripts", "torch", name), *args],
                  env, f"scripts/torch/{name}")


def _eval_blocks(run_dir: str) -> list:
    """eval.log.txt's blocks, one per inference, without their
    timestamps."""
    blocks = []
    with open(os.path.join(run_dir, "eval.log.txt")) as f:
        for line in f.read().splitlines():
            if line.startswith("test "):
                blocks[-1].append(line)
            else:
                blocks.append([])
    return blocks


def _leaves(tree, path=()):
    """(path, leaf) of every leaf of a tree of dicts."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _entry_converter(workdir: str, env) -> None:
    """(a) phase_infer's f32 weights as the reference's model.ckpt pickle,
    `python -m dldkd_tpu_torch.convert` and do_test.sh in fresh processes;
    the converted directory against phase_infer's own."""
    import shutil

    import numpy as np
    import torch

    from dldkd_tpu_torch import convert
    from dldkd_tpu_torch.checkpoint import read_checkpoint

    model = _serving_model("float32", INFER_SEED)
    src = os.path.join(workdir, "run_float32")
    ref = os.path.join(workdir, "reference_model.ckpt")
    convert._ensure_fake_easydict()
    saved_cfg = sys.modules["easydict"].EasyDict({
        k: getattr(model.config, k) for k in (
            "visual_input_size", "query_input_size", "max_ctx_l",
            "max_desc_l", "n_heads", "input_drop", "drop",
            "initializer_range", "margin", "hard_pool_size")})
    torch.save({"model": {"module." + k: v.detach().cpu()
                          for k, v in model.state_dict().items()},
                "model_cfg": saved_cfg, "epoch": 5}, ref)
    run = os.path.join(workdir, "run_converted")
    # the model's own label_style: _write_run's config keeps the default
    convert_s = _fresh([sys.executable, "-m", "dldkd_tpu_torch.convert",
                        "--torch_ckpt", ref, "--out_dir",
                        os.path.join(run, "ckpt"), "--label_style",
                        model.config.label_style], env,
                       "python -m dldkd_tpu_torch.convert")
    shutil.copy(os.path.join(src, "opt.json"), os.path.join(run, "opt.json"))
    test_s = _script("do_test.sh", ["synthetic", "i3d",
                                    os.path.join(workdir, "data"), run], env)
    converted = read_checkpoint(os.path.join(run, "ckpt"))
    got = dict(_leaves(converted["params"]))
    want = dict(_leaves(read_checkpoint(os.path.join(src, "ckpt"))["params"]))
    bitwise = got.keys() == want.keys() and all(
        got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
        for k in want)
    cfgs = []
    for d in (run, src):
        with open(os.path.join(d, "ckpt", "model_cfg.json")) as f:
            cfgs.append(json.load(f))
    epoch = int(converted["epoch"])
    conv_eval, direct_eval = _eval_blocks(run)[-1], _eval_blocks(src)[-1]
    emit({"phase": "entry_converter", "convert_s": convert_s,
          "do_test_s": test_s, "params_bitwise": bitwise,
          "n_params": len(got), "model_cfg_equal": cfgs[0] == cfgs[1],
          "epoch": epoch, "do_test_eval": conv_eval,
          "infer_main_eval": direct_eval})
    if not bitwise or cfgs[0] != cfgs[1] or epoch != 5:
        fail(f"converter: parameters bitwise {bitwise}, model_cfg.json "
             f"{cfgs[0]} against {cfgs[1]}, epoch {epoch}")
    if len(conv_eval) != 3 or conv_eval != direct_eval:
        fail(f"converter: do_test.sh on the converted checkpoint gave "
             f"{conv_eval}, infer.main on the same weights {direct_eval}")


def _entry_dataset(root: str, script, collection, train_feat, eval_feat,
                   flags, env, dev) -> dict:
    """(b) one dataset script and do_test.sh in fresh processes, then one
    validation of the trained checkpoint in this process, through the
    kernels and through the plain versions; returns that validation's
    launch counts."""
    import dataclasses

    import torch

    from dldkd_tpu_torch import checkpoint as ckpt_lib
    from dldkd_tpu_torch import infer
    from dldkd_tpu_torch.config import parse_args
    from dldkd_tpu_torch.convert import load_jax_params
    from dldkd_tpu_torch.evaluate import run_retrieval_eval, score_matrices
    from dldkd_tpu_torch.metrics import build_gt_indices
    from dldkd_tpu_torch.models import DLDKD

    what = f"scripts/torch/{script}"
    res = os.path.join(os.path.dirname(root), f"entry_{collection}")
    train_s = _script(script, [root, "--n_epoch", str(ENTRY["n_epoch"]),
                               "--results_root", res], env)
    run_dir = _run_dir(res)
    steps, sumrs, epochs = _train_history(run_dir)
    _check_losses(steps, what)
    for rel in ("ckpt/model.ckpt", "opt.json", "eval.log.txt"):
        if not os.path.isfile(os.path.join(run_dir, rel)):
            fail(f"{what}: {rel} missing from the run directory")
    if epochs != list(range(ENTRY["n_epoch"])) \
            or len(sumrs) != ENTRY["n_epoch"]:
        fail(f"{what}: epochs {epochs}, validation SumRs {sumrs}")
    with open(os.path.join(run_dir, "opt.json")) as f:
        opt = json.load(f)
    want = {"collection": collection, "dset_name": collection,
            "visual_feature": train_feat, "q_feat_size": ENTRY["d_query"],
            "model_name": "DLDKD", "label_style": "soft",
            "double_branch": True, "distill_loss_decay": "exp", **flags}
    off = {k: (opt.get(k), v) for k, v in want.items() if opt.get(k) != v}
    if off:
        fail(f"{what}: opt.json differs from the script's flags: {off}")

    test_s = _script("do_test.sh", [collection, eval_feat, root, run_dir],
                     env)
    blocks = _eval_blocks(run_dir)
    # do_test.sh reads the restored opt.json's feature: the post-train
    # inference's metrics again
    if len(blocks) != 2 or len(blocks[1]) != 3 \
            or not blocks[1][2].startswith("test fused") \
            or blocks[1] != blocks[0]:
        fail(f"{what}: eval.log.txt after do_test.sh {collection} "
             f"{eval_feat}: {blocks}")

    # in this process: the feature the restored config names, and on
    # Charades the other directory's metrics, which must differ
    cfg = parse_args(["--model_dir", run_dir, "--root_path", root],
                     test=True, finalize=False)
    if cfg.data.visual_feature != train_feat:
        fail(f"{what}: the restored config names "
             f"{cfg.data.visual_feature}, trained on {train_feat}")
    other = None
    if eval_feat != train_feat:
        infer.start_inference(cfg, device=dev)
        infer.start_inference(dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data,
                                          visual_feature=eval_feat)),
            device=dev)
        blocks = _eval_blocks(run_dir)
        other = blocks[3]
        if blocks[2] != blocks[1] or blocks[3] == blocks[1]:
            fail(f"{what}: {train_feat} in this process gave {blocks[2]}, "
                 f"do_test.sh {blocks[1]}, {eval_feat} {blocks[3]}")

    ckpt_dir = os.path.join(run_dir, "ckpt")
    mcfg = ckpt_lib.load_model_cfg(ckpt_dir)
    params, best_epoch = ckpt_lib.restore_params_only(ckpt_dir)
    model = load_jax_params(DLDKD(mcfg), params).to(dev).eval()
    videos, queries = infer.pack_split(cfg, "val", mcfg)
    _reset_counts()
    with _PlainCalls() as plain:
        t0 = time.perf_counter()
        val = run_retrieval_eval(model, videos, queries, cfg.eval,
                                 device=dev)
        torch.cuda.synchronize()
        val_s = time.perf_counter() - t0
    counts = _counts()
    with torch.no_grad():
        k_i, k_e = score_matrices(model, videos, queries,
                                  cfg.eval.eval_context_bsz,
                                  cfg.eval.eval_query_bsz, dev)
        p_i, p_e = score_matrices(model, videos, queries,
                                  cfg.eval.eval_context_bsz,
                                  cfg.eval.eval_query_bsz, dev, plain=True)
    gt = torch.from_numpy(build_gt_indices(queries.video_ids,
                                           videos.ids)).to(dev)
    rank_flips = int((_rank_rows(k_i, k_e, gt)
                      != _rank_rows(p_i, p_e, gt)).sum())
    score_err = max(max_err(k_i, p_i), max_err(k_e, p_e))
    emit({"phase": "entry_script", "script": script,
          "collection": collection, "train_feature": train_feat,
          "do_test_feature": eval_feat, "train_s": train_s,
          "do_test_s": test_s, "steps": len(steps),
          "loss_overall": [r["Train/loss_overall"] for r in steps],
          "val_fused_sumr": sumrs, "best_epoch": best_epoch,
          "do_test_eval": blocks[1], "other_feature_eval": other,
          "validation_s": val_s, "val_videos": len(videos),
          "val_queries": len(queries), "val_metrics": val,
          "launches": counts, "plain_calls": plain.calls,
          "kernel_vs_plain_scores_max_abs_err": score_err,
          "tol": TOL[("scores", "float32")], "rank_flips": rank_flips})
    _check_metrics(val, f"{what} validation")
    _check_launched(counts, _eval_kernels("float32"), f"{what} validation")
    if plain.calls:
        fail(f"{what} validation: plain versions ran {plain.calls}")
    if rank_flips or not score_err <= TOL[("scores", "float32")]:
        fail(f"{what} validation: kernel vs plain, {rank_flips} ranks "
             f"differ, scores by {score_err}")
    if val["fused"]["sumr"] != max(sumrs):
        fail(f"{what}: the best checkpoint's validation gives fused SumR "
             f"{val['fused']['sumr']}, the run logged {sumrs}")
    del model, k_i, k_e, p_i, p_e
    torch.cuda.empty_cache()
    return counts


def phase_entry_scripts(workdir: str, dev) -> dict:
    """The paper's other entry points on the card, each in a fresh process
    with no device flag: (a) the released-checkpoint converter on
    phase_infer's f32 weights, then do_test.sh on its output; (b)
    scripts/torch/do_activitynet.sh and do_charades.sh at their widths
    (query 1,024) on a small synthetic root, each followed by do_test.sh.
    Returns {path: launch counts} of the in-process validations."""
    from dldkd_tpu_torch.data.synthetic import generate_dataset

    t_phase = time.perf_counter()
    env = _script_env(workdir)
    _entry_converter(workdir, env)
    root = os.path.join(workdir, "entry_data")
    t0 = time.perf_counter()
    for _, collection, train_feat, eval_feat, seeds, _ in ENTRY_SCRIPTS:
        # do_test.sh's feature first: the text files are then the
        # training feature's
        feats = ((eval_feat, seeds[1]),) if eval_feat != train_feat else ()
        for feat, seed in feats + ((train_feat, seeds[0]),):
            generate_dataset(
                root, collection=collection, visual_feature=feat,
                n_videos={"train": ENTRY["n_train"], "val": ENTRY["n_val"],
                          "test": ENTRY["n_test"]},
                frames_range=(20, 200), tokens_range=(5, 31),
                d_student=ENTRY["d_video"], d_query=ENTRY["d_query"],
                d_teacher=ENTRY["d_teacher"], noise=ENTRY["noise"],
                seed=seed, feature_format="npz")
    setup_s = time.perf_counter() - t0
    launches = {}
    for script, collection, train_feat, eval_feat, seeds, flags in \
            ENTRY_SCRIPTS:
        launches[f"{collection} validation"] = _entry_dataset(
            root, script, collection, train_feat, eval_feat, flags, env,
            dev)
    emit({"phase": "entry_scripts", "dataset_setup_s": setup_s,
          "phase_s": time.perf_counter() - t_phase})
    return launches


def _tvr_data(dev, seed: int):
    """TVR test-split shapes, made on the card from a seed: ragged frame
    and token counts, L2-normalized rows as the packers write them, five
    captions per video."""
    import torch

    from dldkd_tpu_torch.data.ingest import PackedQueries, PackedVideos

    gen = torch.Generator(device=dev).manual_seed(seed)
    nv, nq = TVR["n_videos"], TVR["n_queries"]

    def rows(n, l, d, low):
        x = torch.randn(n, l, d, generator=gen, device=dev)
        x = x / (x.norm(dim=-1, keepdim=True) + 1e-5)
        lengths = torch.randint(low, l + 1, (n,), generator=gen, device=dev)
        mask = (torch.arange(l, device=dev)[None] < lengths[:, None]).float()
        return ((x * mask[..., None]).cpu().numpy(), mask.cpu().numpy())

    vf, vm = rows(nv, TVR["frames"], TVR["d_video"], 8)
    qf, qm = rows(nq, TVR["tokens"], TVR["d_query"], 5)
    ids = [f"video{i:05d}" for i in range(nv)]
    q_vid = [ids[i % nv] for i in range(nq)]
    videos = PackedVideos(feats=vf, mask=vm, ids=ids)
    queries = PackedQueries(feats=qf, mask=qm,
                            cap_ids=[f"{v}#enc#{i // nv}"
                                     for i, v in enumerate(q_vid)],
                            video_ids=q_vid)
    return videos, queries


def _short_kernel_name(name: str) -> str:
    if "sim_max_mma_kernel" in name:   # csrc/sim_max_mma.cu, by instance
        for inst, short in (("Int8", "sim_max_int8"), ("Tf32", "sim_max_f32"),
                            ("Exact", "sim_max_exact")):
            if inst in name:
                return short
        return "sim_max_kernel"
    # gemm_kernel: a SIMT product, which the f32 profile must not show;
    # layernorm_kernel, pool_kernel: separate LayerNorm and pooling passes,
    # which no profile may show (UNFUSED_EPILOGUES)
    for k in ("gemm_mma_kernel", "gemm_rows_kernel", "attention_mma_kernel",
              "normalize_kernel", "gemm_kernel", "layernorm_kernel",
              "pool_kernel", "quantize_q8_kernel"):
        if k in name:
            return k
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return name.split(" (")[0]
    return "other: " + name[:60]


# the towers' kernels as _short_kernel_name names them: a query-tower
# launch runs 5 (normalize, gemm_rows for the projection and its
# LayerNorm, gemm_mma for Q|K|V, attention, gemm_rows for the output
# product, its LayerNorm and the pooling), a video-tower launch 6 (the
# second gemm_rows without pooling, then gemm_mma for out_mapping), and
# each int8 epilogue (tower or standalone) one quantize_q8
TOWER_KERNELS = ("normalize_kernel", "gemm_mma_kernel", "gemm_rows_kernel",
                 "attention_mma_kernel", "quantize_q8_kernel")
KERNELS_PER_LAUNCH = {"query_tower": 5, "context_tower": 6,
                      "context_tower_q8": 1, "context_tower_q8_t": 1}
# the LayerNorm and pooling passes that the products' epilogues replaced
UNFUSED_EPILOGUES = ("layernorm_kernel", "pool_kernel")


def profile_eval(model, videos, queries, dev, score_quant=False,
                 stream: int = 0) -> dict:
    """One eval (`eval_at`) under torch.profiler (the resident engine, or
    with stream > 0 the streaming one with that corpus block at 64 queries
    per query-tower launch): device time by kernel, the towers' and the
    scorers', the host-to-device copies' and how much of it ran while a
    kernel ran, and the share of the wall time in which no kernel or copy
    ran. Fails if a separate LayerNorm or pooling kernel ran, or if the
    towers' kernels are not KERNELS_PER_LAUNCH of the tower launches the
    eval counted (5 a query tower, 6 a video tower, 1 an int8 epilogue)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dldkd_tpu_torch.tools.train_bench import span_union

    before = _counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eval_at(model, videos, queries, dev,
                STREAM["query_bsz"] if stream else TVR["query_bsz"],
                TVR["context_bsz"], score_quant, stream)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, copies, kernels, by_name = [], [], [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        key = _short_kernel_name(e.name)
        if key == "Memcpy HtoD":
            copies.append((start, end))
        elif not key.startswith("Mem"):
            kernels.append((start, end))
        t, c = by_name.get(key, (0.0, 0))
        by_name[key] = (t + (end - start), c + 1)
    what = f"profiled eval ({'streaming' if stream else 'resident'}, " \
        f"score_quant={score_quant})"
    unfused = {k: by_name[k][1] for k in UNFUSED_EPILOGUES if k in by_name}
    if unfused:
        fail(f"{what}: separate LayerNorm or pooling kernels ran: {unfused}")
    counts = _counts()
    tower_launches = {k: counts[k] - before[k] for k in KERNELS_PER_LAUNCH}
    tower_kernels = sum(by_name.get(k, (0.0, 0))[1] for k in TOWER_KERNELS)
    want = sum(KERNELS_PER_LAUNCH[k] * n for k, n in tower_launches.items())
    if tower_kernels != want:
        fail(f"{what}: {tower_kernels} tower kernels for the launches "
             f"{tower_launches} (want {want})")
    busy = span_union(spans)
    copy_busy, kernel_busy = span_union(copies), span_union(kernels)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    towers = sum(by_name.get(k, (0.0, 0))[0] for k in TOWER_KERNELS)
    scoring = sum(t for k, (t, _) in by_name.items()
                  if k.startswith("sim_max"))
    return {"engine": f"streaming, block {stream}" if stream
            else "resident",
            "profiled_wall_ms": wall_us / 1e3,
            "device_busy_ms": busy / 1e3,
            "towers_device_ms": towers / 1e3,
            "scoring_device_ms": scoring / 1e3,
            "copies_h2d_ms": copy_busy / 1e3,
            # copy time during which some kernel also ran
            "copies_h2d_overlapped_ms": (copy_busy + kernel_busy
                                         - span_union(copies + kernels)) / 1e3,
            "simt_products": by_name.get("gemm_kernel", (0.0, 0))[1],
            "tower_launches": tower_launches,
            "tower_kernels": tower_kernels,
            "device_idle_share": (1.0 - busy / wall_us) if wall_us else None,
            "device_events": len(spans),
            "device_ms_by_kernel": {k: {"ms": t / 1e3, "count": c}
                                    for k, (t, c) in top}}


def phase_tvr_eval(dev):
    """The resident eval (`eval_at`) at TVR test scale, then kernel vs
    plain."""
    import torch

    from dldkd_tpu_torch.evaluate import (_metrics_from_score_matrices,
                                          score_matrices)
    from dldkd_tpu_torch.metrics import build_gt_indices

    t0 = time.perf_counter()
    videos, queries = _tvr_data(dev, seed=5)
    setup_s = time.perf_counter() - t0
    counts_by_dtype = {}
    for dtype in ("bfloat16", "float32"):
        model = _serving_model(dtype, seed=6)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        metrics = eval_at(model, videos, queries, dev, TVR["query_bsz"],
                          TVR["context_bsz"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _counts()
        peak = torch.cuda.max_memory_allocated()
        _check_metrics(metrics, f"TVR eval {dtype}")
        _check_launched(counts, _eval_kernels(dtype), f"TVR eval {dtype}")
        counts_by_dtype[dtype] = counts
        prof = profile_eval(model, videos, queries, dev)
        emit({"phase": "tvr_eval_profile", "dtype": dtype, **prof})
        if prof["simt_products"]:
            fail(f"TVR eval {dtype}: {prof['simt_products']} SIMT products "
                 f"(gemm_kernel) in the profile")
        # the kernel path's score matrices against the plain path's
        k_i, k_e = score_matrices(model, videos, queries,
                                  TVR["context_bsz"], TVR["query_bsz"], dev)
        p_i, p_e = score_matrices(model, videos, queries,
                                  TVR["context_bsz"], TVR["query_bsz"], dev,
                                  plain=True)
        torch.cuda.synchronize()
        err = max(max_err(k_i, p_i), max_err(k_e, p_e))
        tol = TOL[("scores", dtype)]
        gt = torch.from_numpy(build_gt_indices(queries.video_ids,
                                               videos.ids)).to(dev)
        plain_fused = _metrics_from_score_matrices(p_i, p_e, gt,
                                                   (0.7, 0.3))["fused"]
        emit({"phase": "tvr_eval", "dtype": dtype,
              "videos": len(videos), "queries": len(queries),
              "data_setup_s": setup_s, "seconds": secs,
              "queries_per_s": len(queries) / secs,
              "peak_mem_bytes": peak, "launches": counts,
              "scores_max_abs_err": err, "tol": tol, "metrics": metrics,
              "plain_path_fused_sumr": plain_fused["sumr"]})
        if not err <= tol:
            fail(f"TVR eval {dtype}: kernel vs plain scores differ by {err} "
                 f"> {tol}")
        if dtype == "float32" and metrics["fused"]["sumr"] \
                != plain_fused["sumr"]:
            fail(f"TVR eval float32: fused SumR {metrics['fused']['sumr']} "
                 f"vs the plain path's {plain_fused['sumr']}")
        del model, k_i, k_e, p_i, p_e
        torch.cuda.empty_cache()
    return counts_by_dtype, videos, queries


# ------------------------------------------- slice 2: int8, exact, serving

def _q8_rows(n, l, d, gen, dev):
    """int8 index rows of random unit frames, and their ragged mask."""
    import torch

    from dldkd_tpu_torch.ops.kernels import query_tower as qt

    frames = torch.randn(n, l, d, generator=gen).to(dev, torch.bfloat16)
    return qt.quantize_frames_q8(frames, plain=True), \
        _ragged_mask(n, l, 8, gen, dev)


def phase_kernels_slice2(dev):
    """The int8 scoring kernel, the exact-rescore kernel and the towers'
    int8 epilogue against their plain versions at the main paths' shapes;
    then the rates behind the stage-2 cost model."""
    import torch

    from dldkd_tpu_torch.ops import similarity
    from dldkd_tpu_torch.ops.fast_eval import tower_weights
    from dldkd_tpu_torch.ops.kernels import query_tower as qt
    from dldkd_tpu_torch.ops.kernels import sim_max
    from dldkd_tpu_torch.ops.masking import l2_normalize

    gen = torch.Generator().manual_seed(11)
    results = {}
    nv, lf, h = TVR["n_videos"], TVR["frames"], TVR["hidden"]

    # ---- int8 scoring: the eval's query batch (50) and serving's (256)
    c8, mask = _q8_rows(nv, lf, h, gen, dev)
    bias = sim_max.q8_index_bias(mask)
    valid = mask.max(dim=1).values > 0
    for nq in (TVR["query_bsz"], SERVE["query_bsz"]):
        q = torch.randn(nq, h, generator=gen).to(dev, torch.bfloat16)
        q8 = sim_max.quantize_unit_int8(l2_normalize(q)).contiguous()
        got = sim_max.fused_clip_scores_int8(q8, c8, bias)
        want = sim_max.fused_clip_scores_int8(q8, c8, bias, plain=True)
        torch.cuda.synchronize()
        err = max_err(got[:, valid], want[:, valid])
        n_bytes = nq * h + nv * lf * h + nv * lf * 4 + nq * nv * 4
        b_ms, b_by = bound(n_bytes, 2 * nq * nv * lf * h, "int8")
        rec = {"check": "sim_max_int8", "dtype": "int8",
               "shape": {"q": [nq, h], "ctx": [nv, lf, h]},
               "max_abs_err": err, "tol": TOL[("sim_max_int8", "int8")],
               "bitwise_valid_columns": bool(torch.equal(got[:, valid],
                                                         want[:, valid])),
               "kernel_ms": cuda_ms(scoring_launch(
                   "sim_max_int8", q8, c8, bias)),
               "wrapper_ms": cuda_ms(lambda: sim_max.fused_clip_scores_int8(
                   q8, c8, bias)),
               "plain_ms": cuda_ms(lambda: sim_max.fused_clip_scores_int8(
                   q8, c8, bias, plain=True)),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
               # yardstick only: the bare int8 product, every frame score
               # written in int32, no bias, no max
               "product_ms": cuda_ms(lambda: torch._int_mm(
                   q8, c8.view(nv * lf, h).t())),
               "smem": _scoring_smem("int8", nq, h)}
        emit(rec)
        results[("sim_max_int8", nq)] = rec
        if not rec["bitwise_valid_columns"]:
            fail(f"sim_max_int8 nq={nq}: valid columns differ from the plain "
                 f"version by {err}")
    del c8, bias

    # ---- exact rescoring over bf16 frames, 256 queries
    nq = SERVE["query_bsz"]
    ctx = torch.randn(nv, lf, h, generator=gen).to(dev, torch.bfloat16)
    q = torch.randn(nq, h, generator=gen).to(dev)
    qn = l2_normalize(q).contiguous()
    inv, xbias = sim_max.exact_frame_scales(ctx, mask)
    got = sim_max.sim_max_exact_launch(qn, ctx, inv, xbias)
    want = sim_max.sim_max_exact_plain(qn, ctx, inv, xbias)
    torch.cuda.synchronize()
    err = max_err(got, want)
    tol = TOL[("sim_max_exact", "float32")]
    n_bytes = nq * h * 4 + nv * lf * h * 2 + 2 * nv * lf * 4 + nq * nv * 4
    # three bf16 products, one per part of the split query
    b_ms, b_by = bound(n_bytes, 3 * 2 * nq * nv * lf * h, "bfloat16")
    exact_ms = cuda_ms(lambda: sim_max.sim_max_exact_launch(qn, ctx, inv,
                                                            xbias))
    parts = sim_max.split_bf16x3(qn)
    c2 = ctx.view(nv * lf, h)

    def products():
        for p in parts:
            torch.matmul(p, c2.t())
    rec = {"check": "sim_max_exact", "dtype": "float32 x bf16 frames",
           "shape": {"q": [nq, h], "ctx": [nv, lf, h]},
           "max_abs_err": err, "tol": tol,
           "kernel_ms": cuda_ms(scoring_launch("sim_max_exact", qn, ctx,
                                               inv, xbias)),
           "wrapper_ms": exact_ms,
           "plain_ms": cuda_ms(lambda: sim_max.sim_max_exact_plain(
               qn, ctx, inv, xbias), n=10),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
           # yardstick only: the three bf16 products, every frame score
           # written, no scale, no max
           "product_ms": cuda_ms(products, n=10),
           "smem": _scoring_smem("exact", nq, h)}
    emit(rec)
    results[("sim_max_exact", nq)] = rec
    if not err <= tol:
        fail(f"sim_max_exact: max abs error {err} > {tol}")

    # ---- the rates of the stage-2 cost model (similarity.py constants)
    scales_ms = cuda_ms(lambda: sim_max.exact_frame_scales(ctx, mask))
    cand = torch.stack([torch.randperm(nv, generator=gen)[:SERVE["shortlist"]]
                        for _ in range(nq)]).to(dev)
    gather_ms = cuda_ms(lambda: similarity.rescore_shortlist(q, ctx, mask,
                                                             cand), n=10)
    ctx32 = ctx.float()
    cn32 = l2_normalize(ctx32).contiguous()
    f32_ms = cuda_ms(lambda: sim_max.fused_clip_scores(qn, cn32, mask))
    norm32_ms = cuda_ms(lambda: l2_normalize(ctx32), n=10)
    flops = 2.0 * nq * nv * lf * h
    rates = {"gather_bytes_per_s": nq * SERVE["shortlist"] * lf * h * 2
             / (gather_ms * 1e-3),
             "dense_flops_bf16": flops / (exact_ms * 1e-3),
             "dense_flops_f32": flops / (f32_ms * 1e-3),
             "dense_scales_bytes_per_s": nv * lf * h * 2 / (scales_ms * 1e-3),
             "dense_norm_f32_bytes_per_s": nv * lf * h * 4
             / (norm32_ms * 1e-3)}
    emit({"check": "dense_rescore", "shape": {"q": nq, "k_short":
                                              SERVE["shortlist"],
                                              "ctx": [nv, lf, h]},
          "gather_ms": gather_ms, "exact_kernel_ms": exact_ms,
          "frame_scales_ms": scales_ms, "f32_kernel_ms": f32_ms,
          "f32_normalize_ms": norm32_ms, **rates,
          "dense_wins_at_tvr_serving": similarity.dense_rescore_wins(
              nq, SERVE["shortlist"], nv, lf, h, 2),
          "model_constants": {
              "gather_bytes_per_s": similarity._GATHER_BYTES_PER_S,
              "dense_flops_bf16": similarity._DENSE_FLOPS_BF16,
              "dense_flops_f32": similarity._DENSE_FLOPS_F32,
              "dense_bytes_per_s_bf16": similarity._DENSE_BYTES_PER_S_BF16,
              "dense_bytes_per_s_f32": similarity._DENSE_BYTES_PER_S_F32}})
    del ctx, ctx32, cn32, inv, xbias, got, want, parts, c2
    torch.cuda.empty_cache()

    # ---- the towers' int8 epilogue: both launches, 200 videos
    n, d = TVR["context_bsz"], TVR["d_video"]
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        item = torch.tensor([], dtype=tdt).element_size()
        model = _serving_model(dtype, seed=12)
        ws = tower_weights(model, dev)["context"]
        x = torch.randn(n, lf, d, generator=gen)
        x = (x / x.norm(dim=-1, keepdim=True)).to(dev)
        xm = _ragged_mask(n, lf, 3, gen, dev)
        for branches in (2, 1):
            w = ws[:branches]
            got = qt.context_towers(x, xm, w, TVR["heads"], tdt, "check",
                                    emit_q8=True)
            frames = qt.context_towers(x, xm, w, TVR["heads"], tdt, "check")
            plain = qt.context_towers(x, xm, w, TVR["heads"], tdt, "check",
                                      plain=True, emit_q8=True)
            torch.cuda.synchronize()
            err = max(max_err(g, qt.quantize_frames_q8_plain(f))
                      for g, f in zip(got, frames))
            diff = [(g.int() - p.int()).abs() for g, p in zip(got, plain)]
            y = torch.stack(frames)
            n_el = y.numel()
            b_ms, b_by = bound(n_el * item + n_el, 6 * n_el, "float32")
            rec = {"check": "context_tower_q8", "dtype": dtype,
                   "branches": branches,
                   "shape": {"frames": [branches, n, lf, h]},
                   "max_abs_err": err,
                   "tol": TOL[("context_tower_q8", dtype)],
                   "vs_plain_towers_max_levels": int(max(
                       t.max() for t in diff)),
                   "vs_plain_towers_share_off": float(sum(
                       (t > 0).sum() for t in diff)) / n_el,
                   "kernel_ms": cuda_ms(lambda: qt.quantize_frames_q8(y)),
                   "device_ms": device_ms(lambda: qt.quantize_frames_q8(y)),
                   "plain_ms": cuda_ms(lambda: qt.quantize_frames_q8(
                       y, plain=True), n=10),
                   "tower_with_epilogue_ms": cuda_ms(
                       lambda: qt.context_towers(x, xm, w, TVR["heads"], tdt,
                                                 "check", emit_q8=True),
                       n=10),
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
            rec["share_of_bound"] = b_ms / rec["device_ms"]
            emit(rec)
            results[("context_tower_q8", dtype, branches)] = rec
            if not err <= rec["tol"]:
                fail(f"context_tower_q8 {dtype} x{branches}: the epilogue "
                     f"differs from its plain version by {err}")
            if rec["vs_plain_towers_max_levels"] > 1:
                fail(f"context_tower_q8 {dtype} x{branches}: int8 rows more "
                     f"than one level from the plain towers'")
        del model, ws
        torch.cuda.empty_cache()
    results.update(_q8_serving_and_exhaustive(dev))
    return results


def _q8_serving_and_exhaustive(dev) -> dict:
    """The int8 epilogue at the serving index build's shape (one launch a
    branch over the corpus's 2,179 x 128 frames, `serving._build_q8`),
    both dtypes, bitwise against its plain version, timed beside its bound
    (`tools/tower_epilogues.q8_case`); and the bf16 reciprocal's proof:
    the quotient of every bf16 value against every bf16 norm, which must
    equal the divide's (`query_tower.q8_reciprocal_mismatches`)."""
    import torch

    from dldkd_tpu_torch.ops.kernels import query_tower as qt
    from dldkd_tpu_torch.tools import tower_epilogues as te

    out = {}
    rows = TVR["n_videos"] * TVR["frames"]
    for dtype in ("bfloat16", "float32"):
        rec = te.q8_case("serving corpus, one branch a launch", rows, None,
                         dtype, dev)
        rec = {"check": "context_tower_q8_serving", **rec,
               "launches_per_index_build": 2}
        emit(rec)
        out[("context_tower_q8_serving", dtype)] = rec
        if not rec["bitwise_vs_plain"]:
            fail(f"context_tower_q8 {dtype} at the serving corpus: the "
                 f"epilogue differs from its plain version")
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bad = qt.q8_reciprocal_mismatches(dev)
    rec = {"check": "q8_reciprocal_exhaustive", "pairs": 2 ** 32,
           "mismatches": bad, "seconds": time.perf_counter() - t0}
    emit(rec)
    out["q8_reciprocal_exhaustive"] = rec
    if bad:
        fail(f"the bf16 epilogue's reciprocal differs from the divide on "
             f"{bad} of the 2^32 bf16 pairs")
    return out


def _check_jsonl(path: str, n_lines: int, k: int, ids, what: str) -> None:
    with open(path) as f:
        lines = [json.loads(x) for x in f]
    if len(lines) != n_lines:
        fail(f"{what}: {len(lines)} result lines, want {n_lines}")
    for line in lines:
        top = line["topk"]
        if len(top) != k or any(v not in ids or not math.isfinite(s)
                                for v, s in top):
            fail(f"{what}: bad result line {line}")


def phase_serving_cli(workdir: str, root: str):
    """infer.main --score_quant and serving.main on the synthetic dataset
    of phase 4, bf16."""
    from dldkd_tpu_torch import infer, serving
    from dldkd_tpu_torch.data.ingest import (dataset_paths, open_features,
                                             read_video_ids)

    run_dir = os.path.join(workdir, "run_bfloat16")
    _reset_counts()
    t0 = time.perf_counter()
    metrics = infer.main(["--model_dir", run_dir, "--root_path", root,
                          "--torch_device", "cuda", "--score_quant"])
    secs = time.perf_counter() - t0
    counts = _counts()
    emit({"phase": "infer.main --score_quant", "dtype": "bfloat16",
          "videos": 300, "seconds": secs, "launches": counts,
          "metrics": metrics})
    _check_metrics(metrics, "infer.main --score_quant")
    _check_launched(counts, INT8_EVAL_KERNELS, "infer.main --score_quant")

    paths = dataset_paths(root, "synthetic", "i3d")
    ids = set(read_video_ids(paths["cap_file"]["test"]))
    with open_features(paths["text_feat"]) as f:
        n_caps = len(list(f.keys()))
    routes = (("exact", [], ("sim_max", "query_tower", "context_tower")),
              ("two_stage", ["--score_quant"],
               ("sim_max_int8", "query_tower", "context_tower",
                "context_tower_q8")),
              ("int8", ["--score_quant", "--no_rescore"],
               INT8_EVAL_KERNELS))
    for name, extra, kernels in routes:
        out = os.path.join(workdir, f"serve_{name}.jsonl")
        _reset_counts()
        t0 = time.perf_counter()
        serving.main(["--model_dir", run_dir, "--root_path", root,
                      "--collection", "synthetic", "--visual_feature", "i3d",
                      "--queries", paths["text_feat"], "--k", "5",
                      "--out", out] + extra)
        secs = time.perf_counter() - t0
        counts = _counts()
        emit({"phase": "serving.main", "route": name, "dtype": "bfloat16",
              "queries": n_caps, "seconds": secs, "launches": counts})
        _check_jsonl(out, n_caps, 5, ids, f"serving.main {name}")
        _check_launched(counts, kernels, f"serving.main {name}")
    _native_pack_check(root)
    _serving_cli_artifact(workdir, root, run_dir, paths["text_feat"],
                          os.path.join(workdir, "serve_two_stage.jsonl"))


def _native_pack_check(root: str) -> None:
    """The native corpus packer on this machine's disk corpus (the
    synthetic dataset of phase 4) against the numpy path (fault C2)."""
    import numpy as np

    from dldkd_tpu_torch.data import BigFile, native, pack_video_corpus
    from dldkd_tpu_torch.data.ingest import (dataset_paths, read_dict,
                                             read_video_ids)

    paths = dataset_paths(root, "synthetic", "i3d")

    def pack():
        return pack_video_corpus(read_video_ids(paths["cap_file"]["test"]),
                                 BigFile(paths["visual_feat_dir"]),
                                 read_dict(paths["video2frames"]),
                                 max_ctx_l=TVR["frames"])

    native.LAUNCHES["pack_corpus"] = 0
    t0 = time.perf_counter()
    fast = pack()
    native_s = time.perf_counter() - t0
    calls = native.LAUNCHES["pack_corpus"]
    os.environ["DLDKD_NO_NATIVE"] = "1"
    try:
        t0 = time.perf_counter()
        slow = pack()
        numpy_s = time.perf_counter() - t0
    finally:
        del os.environ["DLDKD_NO_NATIVE"]
    diff = np.abs(fast.feats - slow.feats)
    ulp = np.spacing(np.maximum(np.abs(fast.feats), np.abs(slow.feats)))
    ulps = float((diff / ulp).max())
    rec = {"check": "native_pack", "videos": len(fast), "shape":
           list(fast.feats.shape), "native_calls": calls,
           "library": str(native.library_path()), "native_s": native_s,
           "numpy_s": numpy_s, "max_abs_diff": float(diff.max()),
           "max_ulps": ulps,
           "masks_equal": bool(np.array_equal(fast.mask, slow.mask))}
    # the JAX package's tolerance between the two paths
    # (tests/test_native.py:83): each normalizes by its own norm, f64 sums
    # and a reciprocal in C++, numpy's f32 norm and a divide in numpy
    rec["tol"] = {"rtol": 1e-5, "atol": 1e-6}
    rec["within_tol"] = bool(np.allclose(fast.feats, slow.feats, rtol=1e-5,
                                         atol=1e-6))
    emit(rec)
    if calls != 1 or not rec["masks_equal"] or not rec["within_tol"]:
        fail(f"native packer: {rec}")


def _serving_cli_artifact(workdir, root, run_dir, queries, built_jsonl):
    """The serving CLI in fresh processes: --save_index with no --queries
    (two-stage, a prewarm manifest), then --load_index with the .npz query
    store and no dataset flags; its lines must be the in-process
    two-stage run's (ids and scores)."""
    idx = os.path.join(workdir, "cli_index")
    out = os.path.join(workdir, "serve_loaded.jsonl")
    runs = {}
    for what, extra in (
            ("save", ["--root_path", root, "--collection", "synthetic",
                      "--visual_feature", "i3d", "--save_index", idx,
                      "--prewarm", "32:5"]),
            ("load", ["--load_index", idx, "--queries", queries, "--k", "5",
                      "--out", out])):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "dldkd_tpu_torch.serving", "--model_dir",
             run_dir, "--score_quant", *extra], capture_output=True,
            text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        runs[what] = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"serving CLI --{what}_index in a fresh process: exit "
                 f"{proc.returncode}: {proc.stderr[-2000:]}")
    with open(built_jsonl) as f:
        want = [json.loads(x) for x in f]
    with open(out) as f:
        got = [json.loads(x) for x in f]
    rec = {"check": "serving_cli_artifact", "route": "two_stage",
           "save_process_s": runs["save"], "load_process_s": runs["load"],
           "artifact_bytes": sum(
               os.path.getsize(os.path.join(idx, f)) for f in os.listdir(idx)),
           "lines": len(got), "same_lines": got == want}
    emit(rec)
    if not rec["same_lines"] or not got:
        fail("serving CLI: --load_index in a fresh process gave other "
             "results than the in-process build")


def phase_int8_eval(dev, videos, queries):
    """The bf16 int8 eval (score_quant) at TVR scale, then its kernel path
    against its plain path."""
    import torch

    from dldkd_tpu_torch.evaluate import (_metrics_from_score_matrices,
                                          score_matrices)
    from dldkd_tpu_torch.metrics import build_gt_indices

    model = _serving_model("bfloat16", seed=6)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    metrics = eval_at(model, videos, queries, dev, TVR["query_bsz"],
                      TVR["context_bsz"], score_quant=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    _check_metrics(metrics, "TVR int8 eval")
    _check_launched(counts, INT8_EVAL_KERNELS, "TVR int8 eval")
    emit({"phase": "tvr_int8_eval_profile", "dtype": "bfloat16",
          **profile_eval(model, videos, queries, dev, score_quant=True)})
    args = (model, videos, queries, TVR["context_bsz"], TVR["query_bsz"],
            dev)
    k_i, k_e = score_matrices(*args, score_quant=True)
    p_i, p_e = score_matrices(*args, plain=True, score_quant=True)
    torch.cuda.synchronize()
    n = len(videos)
    err = max(max_err(k_i[:, :n], p_i[:, :n]), max_err(k_e[:, :n],
                                                        p_e[:, :n]))
    tol = TOL[("scores", "bfloat16")]
    gt = torch.from_numpy(build_gt_indices(queries.video_ids,
                                           videos.ids)).to(dev)
    plain_fused = _metrics_from_score_matrices(p_i, p_e, gt,
                                               (0.7, 0.3))["fused"]
    emit({"phase": "tvr_int8_eval", "dtype": "bfloat16",
          "videos": n, "queries": len(queries), "seconds": secs,
          "queries_per_s": len(queries) / secs, "peak_mem_bytes": peak,
          "launches": counts, "scores_max_abs_err": err, "tol": tol,
          "metrics": metrics, "plain_path_fused_sumr": plain_fused["sumr"]})
    if not err <= tol:
        fail(f"TVR int8 eval: kernel vs plain scores differ by {err} > {tol}")
    del model, k_i, k_e, p_i, p_e
    torch.cuda.empty_cache()
    return counts


SERVING_ROUTES = (
    ("exact", {}, None, ("sim_max", "query_tower", "context_tower")),
    ("two_stage_dense", {"score_quant": True}, "always",
     ("sim_max_int8", "sim_max_exact", "query_tower", "context_tower",
      "context_tower_q8")),
    ("two_stage_gather", {"score_quant": True}, "never",
     ("sim_max_int8", "query_tower", "context_tower", "context_tower_q8")),
    ("int8_only", {"score_quant": True, "rescore": False}, None,
     INT8_EVAL_KERNELS),
)


def phase_serving(dev, videos, queries):
    """The Retriever at TVR scale on each route: throughput, per-batch
    latency, peak memory, launches; dense against gather; each route
    against its plain path on the first queries."""
    import numpy as np
    import torch

    from dldkd_tpu_torch.serving import Retriever

    model = _serving_model("bfloat16", seed=6)
    qf, qm = queries.feats, queries.mask
    nq, bsz, k = len(queries), SERVE["query_bsz"], SERVE["k"]
    tol = TOL[("scores", "bfloat16")]
    results, counts_by_route = {}, {}
    saved_mode = os.environ.get("DLDKD_DENSE_RESCORE")
    try:
        for name, kw, mode, kernels in SERVING_ROUTES:
            if mode is None:
                os.environ.pop("DLDKD_DENSE_RESCORE", None)
            else:
                os.environ["DLDKD_DENSE_RESCORE"] = mode
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            t0 = time.perf_counter()
            r = Retriever(model, query_bsz=bsz, device=dev, **kw)
            r.index(videos, context_bsz=TVR["context_bsz"])
            torch.cuda.synchronize()
            index_s = time.perf_counter() - t0
            r.search(qf[:bsz], qm[:bsz], k)                # warm-up
            t0 = time.perf_counter()
            scores, idx = r.search(qf, qm, k)
            search_s = time.perf_counter() - t0
            counts = _counts()
            peak = torch.cuda.max_memory_allocated()
            _check_launched(counts, kernels, f"serving {name}")
            lat = []
            for b in range(0, nq, bsz):
                t0 = time.perf_counter()
                r.search(qf[b:b + bsz], qm[b:b + bsz], k)
                lat.append((time.perf_counter() - t0) * 1e3)
            del r
            torch.cuda.empty_cache()
            npl = SERVE["plain_queries"]
            rp = Retriever(model, query_bsz=bsz, device=dev, plain=True,
                           **kw)
            rp.index(videos, context_bsz=TVR["context_bsz"])
            ps, pi = rp.search(qf[:npl], qm[:npl], k)
            del rp
            torch.cuda.empty_cache()
            err = float(np.abs(scores[:npl] - ps).max())
            finite = bool(np.isfinite(scores).all())
            rec = {"phase": "serving", "route": name, "dtype": "bfloat16",
                   "videos": len(videos), "queries": nq, "query_bsz": bsz,
                   "k": k, "dense_rescore_mode": mode or "auto",
                   "index_s": index_s, "search_s": search_s,
                   "queries_per_s": nq / search_s,
                   "batch_ms_p50": float(np.percentile(lat, 50)),
                   "batch_ms_p99": float(np.percentile(lat, 99)),
                   "peak_mem_bytes": peak, "launches": counts,
                   "plain_queries": npl, "plain_scores_max_abs_err": err,
                   "plain_rows_same_ids": float(np.mean(np.all(
                       idx[:npl] == pi, axis=1))),
                   "tol": tol, "finite": finite}
            emit(rec)
            results[name] = (scores, idx)
            counts_by_route[name] = counts
            if not finite or not err <= tol:
                fail(f"serving {name}: kernel path vs plain path: max abs "
                     f"score error {err} > {tol}, or non-finite scores")
    finally:
        if saved_mode is None:
            os.environ.pop("DLDKD_DENSE_RESCORE", None)
        else:
            os.environ["DLDKD_DENSE_RESCORE"] = saved_mode
    # dense and gather stage 2: both exact-grade, so where their ids differ
    # the score lists agree (near-ties), or the gather missed a video its
    # shortlist did not hold (then dense scores higher); gather may never
    # score above dense
    (ds, di), (gs, gi) = results["two_stage_dense"], \
        results["two_stage_gather"]
    tie_tol = TOL[("dense_vs_gather", "scores")]
    same = np.all(di == gi, axis=1)
    near = ~same & np.all(np.abs(ds - gs) <= tie_tol, axis=1)
    emit({"check": "dense_vs_gather", "rows": len(same),
          "rows_same_ids": int(same.sum()), "rows_near_ties": int(near.sum()),
          "rows_shortlist_miss": int((~same & ~near).sum()),
          "max_gather_above_dense": float((gs - ds).max()),
          "tol": tie_tol})
    if not (gs <= ds + tie_tol).all():
        fail("serving: the gather stage 2 scored above the dense one")
    del model
    torch.cuda.empty_cache()
    return counts_by_route


# ------------------------------------------------- slice 8: streaming

def _scorer_inputs(kind, nq, nv, lf, h, gen, dev):
    """(C entry, wrapper on the first n videos, plain version on them,
    per-frame tensors) of one scorer at every query x a corpus block."""
    import torch

    from dldkd_tpu_torch.ops.kernels import sim_max
    from dldkd_tpu_torch.ops.masking import l2_normalize

    mask = _ragged_mask(nv, lf, 8, gen, dev)
    if kind == "int8":
        c, _ = _q8_rows(nv, lf, h, gen, dev)
        q = sim_max.quantize_unit_int8(l2_normalize(
            torch.randn(nq, h, generator=gen).to(dev))).contiguous()
        per = (sim_max.q8_index_bias(mask),)
        return ("sim_max_int8", q, c, per,
                lambda n: sim_max.fused_clip_scores_int8(
                    q, c[:n], per[0][:n]),
                lambda n: sim_max.sim_max_int8_plain(q, c[:n], per[0][:n]))
    q = l2_normalize(torch.randn(nq, h, generator=gen).to(dev)).contiguous()
    if kind == "exact":
        c = torch.randn(nv, lf, h, generator=gen).to(dev, torch.bfloat16)
        per = sim_max.exact_frame_scales(c, mask)
        return ("sim_max_exact", q, c, per,
                lambda n: sim_max.sim_max_exact_launch(
                    q, c[:n], per[0][:n], per[1][:n]),
                lambda n: sim_max.sim_max_exact_plain(
                    q, c[:n], per[0][:n], per[1][:n]))
    tdt = getattr(torch, kind)
    q = q.to(tdt)
    c = l2_normalize(torch.randn(nv, lf, h, generator=gen).to(dev, tdt)
                     ).contiguous()
    return ("sim_max_f32" if kind == "float32" else "sim_max_bf16", q, c,
            (mask,), lambda n: sim_max.fused_clip_scores(q, c[:n], mask[:n]),
            lambda n: sim_max.sim_max_plain(q, c[:n], mask[:n]))


def _stream_kernel_checks(dev) -> dict:
    """Each kernel of the streaming paths against its plain version at the
    shapes streaming gives it: every TVR query (10,895) against one corpus
    block in one scorer launch (checked at 512 videos, timed at 512 and
    2,048); the dual video tower on a whole 2,048-video block in both
    dtypes, and with its int8 epilogue (bitwise against the epilogue's
    plain version on the same launch's frames); the dual query tower at 64
    queries. Bounds count this call's shapes; product_ms is the bare
    products' time, a yardstick."""
    import torch

    from dldkd_tpu_torch.ops.fast_eval import tower_weights
    from dldkd_tpu_torch.ops.kernels import query_tower as qt
    from dldkd_tpu_torch.ops.kernels import sim_max

    gen = torch.Generator().manual_seed(21)
    nq, lf, h = TVR["n_queries"], TVR["frames"], TVR["hidden"]
    blocks, nc = STREAM["blocks"], STREAM["check_block"]
    out = {}
    for kind in ("bfloat16", "float32", "int8", "exact"):
        entry, q, c, per, run, plain = _scorer_inputs(
            kind, nq, max(blocks), lf, h, gen, dev)
        got, want = run(nc), plain(nc)
        torch.cuda.synchronize()
        if kind == "int8":
            valid = per[0][:nc].max(dim=1).values == 0
            err = max_err(got[:, valid], want[:, valid])
        else:
            err = max_err(got, want)
        tol = TOL[("sim_max_int8", "int8") if kind == "int8" else
                  ("sim_max_exact", "float32") if kind == "exact" else
                  ("sim_max", kind)]
        item = c.element_size()
        arith, passes = {"bfloat16": ("bfloat16", 1), "float32": ("tf32", 3),
                         "int8": ("int8", 1), "exact": ("bfloat16", 3)}[kind]
        rec = {"check": "stream_scorer", "kernel": entry, "dtype": kind,
               "max_abs_err": err, "tol": tol}
        for nv in blocks:
            n_bytes = (q.numel() * q.element_size() + nv * lf * h * item
                       + sum(t[:nv].numel() * 4 for t in per) + nq * nv * 4)
            b_ms, b_by = bound(n_bytes, passes * 2.0 * nq * nv * lf * h,
                               arith)
            sub = [t[:nv] for t in per]
            rec[f"block_{nv}"] = {
                "shape": {"q": [nq, h], "ctx": [nv, lf, h]},
                "kernel_ms": cuda_ms(scoring_launch(entry, q, c[:nv], *sub),
                                     n=10, warmup=2),
                "bound_ms": b_ms, "bound_by": b_by,
                "smem": _scoring_smem(kind, nq, h)}
        c2 = c[:nc].reshape(nc * lf, h)
        if kind == "int8":
            product = (lambda: torch._int_mm(q, c2.t()))
        elif kind == "exact":
            parts = sim_max.split_bf16x3(q)
            product = (lambda: [torch.matmul(p, c2.t()) for p in parts])
        else:
            product = (lambda: torch.matmul(q, c2.t()))
        rec[f"block_{nc}"].update(
            plain_ms=cuda_ms(lambda: plain(nc), n=3, warmup=1),
            library_ms=None, product_ms=cuda_ms(product, n=3, warmup=1))
        emit(rec)
        out[entry] = rec
        if not err <= tol:
            fail(f"streaming {entry}: {nq} queries x {nc} videos: max abs "
                 f"error {err} > {tol}")
        del q, c, per, got, want, c2, product
        torch.cuda.empty_cache()

    nv, d = max(blocks), TVR["d_video"]
    x = torch.randn(nv, lf, d, generator=gen)
    x = (x / x.norm(dim=-1, keepdim=True)).to(dev)
    xm = _ragged_mask(nv, lf, 8, gen, dev)
    qx = torch.randn(STREAM["query_bsz"], TVR["tokens"], TVR["d_query"],
                     generator=gen).to(dev)
    qm = _ragged_mask(STREAM["query_bsz"], TVR["tokens"], 5, gen, dev)
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        item = torch.tensor([], dtype=tdt).element_size()
        ws = tower_weights(_serving_model(dtype, seed=22), dev)
        for kind, xs, ms, n, l, dk in (
                ("context", x, xm, nv, lf, d),
                ("query", qx, qm, STREAM["query_bsz"], 32, TVR["d_query"])):
            w, packed = ws[kind], ws["packed"][kind][0]
            if kind == "context":
                run = (lambda: qt.context_towers(xs, ms, w, TVR["heads"], tdt,
                                                 "check", packed=packed))
                plain = (lambda: qt.context_towers(xs, ms, w, TVR["heads"],
                                                   tdt, "check", plain=True))
            else:
                run = (lambda: qt.query_towers(xs, ms, w, TVR["heads"], tdt,
                                               TVR["tokens"], "check",
                                               packed=packed))
                plain = (lambda: qt.query_towers(xs, ms, w, TVR["heads"], tdt,
                                                 TVR["tokens"], "check",
                                                 plain=True))
            got, want = run(), plain()
            torch.cuda.synchronize()
            err = max(max_err(a, b) for a, b in zip(got, want))
            tol = TOL[("tower", dtype)]
            w_bytes = sum(t.numel() * t.element_size()
                          for t in packed.values())
            out_n = n * h if kind == "query" else n * l * h
            n_bytes = (n * l * dk * 4 + n * l * 4 + w_bytes
                       + 2 * out_n * (4 if kind == "query" else item))
            b_ms, b_by = bound(n_bytes, (3 if dtype == "float32" else 1) * 2
                               * _tower_flops(n, l, dk, h, kind),
                               "tf32" if dtype == "float32" else dtype)
            xp = torch.nn.functional.pad(xs, (0, 0, 0, l - xs.shape[1]))
            mp = torch.nn.functional.pad(ms, (0, l - ms.shape[1]))
            rec = {"check": "stream_tower", "kernel": f"{kind}_tower",
                   "dtype": dtype, "branches": 2,
                   "shape": {"x": [n, xs.shape[1], dk], "hidden": h},
                   "max_abs_err": err, "tol": tol,
                   "kernel_ms": cuda_ms(lambda: qt.tower_cuda(
                       xp, mp, packed, TVR["heads"], tdt, kind,
                       pos_rows=xs.shape[1]), n=5, warmup=1),
                   "plain_ms": cuda_ms(plain, n=2, warmup=1),
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                   "product_ms": cuda_ms(_tower_products(
                       n, l, dk, h, 2, kind, tdt, gen, dev), n=3,
                       warmup=1)}
            if not err <= tol:
                emit(rec)
                fail(f"streaming {kind} tower {dtype} at {n}: max abs error "
                     f"{err} > {tol}")
            if kind == "context":
                # one launch per block, and the int8 epilogue bitwise
                before = qt.LAUNCHES["context_tower"]
                q8 = qt.context_towers(x, xm, w, TVR["heads"], tdt, "check",
                                       emit_q8=True, packed=packed)
                rec["launches_per_call"] = (qt.LAUNCHES["context_tower"]
                                            - before)
                rec["q8_bitwise"] = all(
                    torch.equal(a, qt.quantize_frames_q8_plain(f))
                    for a, f in zip(q8, got))
                if rec["launches_per_call"] != 1 or not rec["q8_bitwise"]:
                    emit(rec)
                    fail(f"streaming context tower {dtype}: "
                         f"{rec['launches_per_call']} launches for a "
                         f"{nv}-video block, q8 bitwise {rec['q8_bitwise']}")
                out[f"context_tower_q8_{dtype}"] = {
                    "shape": rec["shape"], "bitwise": rec["q8_bitwise"],
                    "max_abs_err": max(
                        max_err(a, qt.quantize_frames_q8_plain(f))
                        for a, f in zip(q8, got))}
                del q8
            emit(rec)
            out[f"{kind}_tower_{dtype}"] = rec
            del got, want
        del ws
        torch.cuda.empty_cache()
    return out


def _rank_rows(s_i, s_e, gt):
    """(Nq,) ranks of the ground truth under the fused scores."""
    from dldkd_tpu_torch.metrics import rank_of_gt

    return rank_of_gt(0.7 * s_i + 0.3 * s_e, gt)


def _stream_stages(model, videos, queries, dev) -> dict:
    """Where a streaming f32 score could part from the resident one, each
    stage's max abs difference between the two schedules: the query tower
    at 64 against 50 rows per launch, the video tower at a 512-video block
    against 200-video launches, the scorer at every query in one launch
    (two warpgroups per block) against 50 (one)."""
    import torch

    from dldkd_tpu_torch.evaluate import embed_corpus, encode_all_queries
    from dldkd_tpu_torch.ops.fast_eval import encode_context_best
    from dldkd_tpu_torch.ops.similarity import clip_scores_maxpool

    q64 = encode_all_queries(model, queries, STREAM["query_bsz"], dev)[0]
    q50 = encode_all_queries(model, queries, TVR["query_bsz"], dev)[0]
    nb = STREAM["check_block"]
    ci = embed_corpus(model, videos, TVR["context_bsz"], dev)[0][:nb]
    feats = torch.from_numpy(videos.feats[:nb]).to(dev)
    mask = torch.from_numpy(videos.mask[:nb]).to(dev)
    bi = encode_context_best(model, feats, mask)[0]
    whole = clip_scores_maxpool(q64, bi, mask)
    parts = torch.cat([clip_scores_maxpool(q64[s:s + TVR["query_bsz"]], bi,
                                           mask)
                       for s in range(0, len(queries), TVR["query_bsz"])])
    return {f"query_tower_{STREAM['query_bsz']}_vs_{TVR['query_bsz']}":
            max_err(q64, q50),
            f"video_tower_{nb}_vs_{TVR['context_bsz']}": max_err(bi, ci),
            f"scorer_all_vs_{TVR['query_bsz']}_queries": max_err(whole,
                                                                  parts)}


def _stream_evals(dev, videos, queries, launches) -> None:
    """The streaming TVR eval in f32, bf16 and int8 at each block: wall
    time, queries/s, peak memory, launches and a profile; then its scores
    against the resident engine's in this call (f32: the same ranks, fused
    SumR equal; bf16 and int8: scores within the eval's bf16 tolerance,
    rank flips counted)."""
    import torch

    from dldkd_tpu_torch.evaluate import (_metrics_from_score_matrices,
                                          score_matrices,
                                          stream_score_matrices)
    from dldkd_tpu_torch.metrics import build_gt_indices

    nv, nq = len(videos), len(queries)
    gt = torch.from_numpy(build_gt_indices(queries.video_ids,
                                           videos.ids)).to(dev)
    for tag, dtype, quant in (("float32", "float32", False),
                              ("bfloat16", "bfloat16", False),
                              ("int8", "bfloat16", True)):
        model = _serving_model(dtype, seed=6)
        runs = {}
        for block in STREAM["blocks"]:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            t0 = time.perf_counter()
            metrics = eval_at(model, videos, queries, dev,
                              STREAM["query_bsz"], score_quant=quant,
                              stream=block)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = _counts()
            peak = torch.cuda.max_memory_allocated()
            what = f"streaming eval {tag} block {block}"
            _check_metrics(metrics, what)
            _check_launched(counts, INT8_EVAL_KERNELS if quant
                            else _eval_kernels(dtype), what)
            n_blocks = -(-nv // block)
            if counts["context_tower"] != n_blocks:
                fail(f"{what}: {counts['context_tower']} video-tower "
                     f"launches for {n_blocks} blocks")
            launches[f"stream_eval_{tag}_{block}"] = counts
            runs[block] = {"seconds": secs, "queries_per_s": nq / secs,
                           "peak_mem_bytes": peak, "launches": counts,
                           "metrics": metrics,
                           "profile": profile_eval(model, videos, queries,
                                                   dev, score_quant=quant,
                                                   stream=block)}
        r_i, r_e = score_matrices(model, videos, queries, TVR["context_bsz"],
                                  TVR["query_bsz"], dev, score_quant=quant)
        r_i, r_e = r_i[:, :nv], r_e[:, :nv]
        ref_ranks = _rank_rows(r_i, r_e, gt)
        ref_fused = _metrics_from_score_matrices(r_i, r_e, gt,
                                                 (0.7, 0.3))["fused"]
        for block, rec in runs.items():
            s_i, s_e = stream_score_matrices(model, videos, queries, block,
                                             STREAM["query_bsz"], dev,
                                             score_quant=quant)
            err = max(max_err(s_i, r_i), max_err(s_e, r_e))
            flips = int((_rank_rows(s_i, s_e, gt) != ref_ranks).sum())
            rec.update(phase="streaming_eval", dtype=tag, block=block,
                       videos=nv, queries=nq,
                       scores_vs_resident_max_abs_err=err,
                       rank_flips_vs_resident=flips,
                       resident_fused_sumr=ref_fused["sumr"])
            if tag == "float32":
                rec["stages_vs_resident"] = _stream_stages(model, videos,
                                                           queries, dev)
            emit(rec)
            if tag == "float32" and (flips or rec["metrics"]["fused"]["sumr"]
                                     != ref_fused["sumr"]):
                fail(f"streaming eval f32 block {block}: {flips} ranks and "
                     f"fused SumR {rec['metrics']['fused']['sumr']} against "
                     f"the resident engine's {ref_fused['sumr']}")
            if not err <= TOL[("scores", "bfloat16")]:
                fail(f"streaming eval {tag} block {block}: scores differ "
                     f"from the resident engine's by {err}")
            del s_i, s_e
        del model, r_i, r_e
        torch.cuda.empty_cache()


def _stream_under_budget(dev, videos, queries, launches) -> None:
    """run_retrieval_eval's auto route with $DLDKD_EVAL_MEM_BUDGET below the
    resident estimate at TVR scale: it must stream (two video-tower
    launches of a 2,048-video block, not 11 of 200) and give the resident
    engine's metrics (f32)."""
    import torch

    from dldkd_tpu_torch.config import EvalConfig
    from dldkd_tpu_torch.evaluate import (DEFAULT_STREAM_BLOCK,
                                          resident_eval_bytes,
                                          run_retrieval_eval)

    model = _serving_model("float32", seed=6)
    need = resident_eval_bytes(len(videos), len(queries), model.config)
    saved = os.environ.get("DLDKD_EVAL_MEM_BUDGET")
    os.environ["DLDKD_EVAL_MEM_BUDGET"] = str(need // 2)
    try:
        _reset_counts()
        t0 = time.perf_counter()
        got = run_retrieval_eval(model, videos, queries, EvalConfig(),
                                 device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _counts()
    finally:
        if saved is None:
            os.environ.pop("DLDKD_EVAL_MEM_BUDGET")
        else:
            os.environ["DLDKD_EVAL_MEM_BUDGET"] = saved
    launches["run_retrieval_eval_budget"] = counts
    want = eval_at(model, videos, queries, dev, 50)
    blocks = -(-len(videos) // DEFAULT_STREAM_BLOCK)
    queries_launches = -(-len(queries) // STREAM["query_bsz"])
    emit({"phase": "run_retrieval_eval_budget", "dtype": "float32",
          "budget_bytes": need // 2, "resident_estimate_bytes": need,
          "seconds": secs, "launches": counts, "metrics": got,
          "equal_to_resident": got == want})
    if counts["context_tower_f32"] != blocks \
            or counts["query_tower_f32"] != queries_launches:
        fail(f"run_retrieval_eval under a budget did not stream: launches "
             f"{counts}")
    if got != want:
        fail("run_retrieval_eval under a budget: metrics differ from the "
             "resident engine's")


RAW_ROUTES = (
    ("exact", {}, ("sim_max_bf16", "query_tower", "context_tower")),
    ("two_stage", {"score_quant": True},
     ("sim_max_int8", "sim_max_exact", "query_tower", "context_tower")),
    ("int8_only", {"score_quant": True, "rescore": False},
     ("sim_max_int8", "query_tower", "context_tower")),
)


def _raw_search(dev, videos, queries, launches) -> None:
    """The raw-store Retriever at TVR scale at each block, bf16, on three
    routes (two-stage with the cost model's stage 2): one search of every
    query, queries/s, peak memory, launches; each route against its plain
    path on the first queries; then in f32 the exact route's ids against
    the encoded store's, every query."""
    import numpy as np
    import torch

    from dldkd_tpu_torch.serving import Retriever

    qf, qm = queries.feats, queries.mask
    nq, bsz, k = len(queries), SERVE["query_bsz"], SERVE["k"]
    npl = SERVE["plain_queries"]
    tol = TOL[("scores", "bfloat16")]
    model = _serving_model("bfloat16", seed=6)
    for block in STREAM["blocks"]:
        for name, kw, kernels in RAW_ROUTES:
            what = f"raw search {name} block {block}"
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            r = Retriever(model, query_bsz=bsz, device=dev, index_store="raw",
                          stream_block=block, **kw)
            r.index(videos)
            torch.cuda.synchronize()
            index_s = time.perf_counter() - t0
            r.search(qf[:bsz], qm[:bsz], k)                # warm-up
            _reset_counts()
            t0 = time.perf_counter()
            scores, idx = r.search(qf, qm, k)
            search_s = time.perf_counter() - t0
            counts = _counts()
            peak = torch.cuda.max_memory_allocated()
            _check_launched(counts, kernels, what)
            launches[f"raw_search_{name}_{block}"] = counts
            store_bytes = (r.raw_feats.numel() * r.raw_feats.element_size()
                           + r.raw_mask.numel() * 4)
            del r
            rp = Retriever(model, query_bsz=bsz, device=dev, plain=True,
                           index_store="raw", stream_block=block, **kw)
            rp.index(videos)
            ps, pi = rp.search(qf[:npl], qm[:npl], k)
            del rp
            torch.cuda.empty_cache()
            err = float(np.abs(scores[:npl] - ps).max())
            emit({"phase": "raw_search", "route": name, "dtype": "bfloat16",
                  "block": block, "videos": len(videos), "queries": nq,
                  "query_bsz": bsz, "k": k, "index_s": index_s,
                  "search_s": search_s, "queries_per_s": nq / search_s,
                  "peak_mem_bytes": peak, "raw_store_bytes": store_bytes,
                  "launches": counts, "plain_queries": npl,
                  "plain_scores_max_abs_err": err, "tol": tol,
                  "plain_rows_same_ids": float(np.mean(np.all(
                      idx[:npl] == pi, axis=1))),
                  "finite": bool(np.isfinite(scores).all())})
            if not np.isfinite(scores).all() or not err <= tol:
                fail(f"{what}: kernel path vs plain path: max abs score "
                     f"error {err} > {tol}, or non-finite scores")
    del model
    model = _serving_model("float32", seed=6)
    enc = Retriever(model, query_bsz=bsz, device=dev, index_store="encoded")
    enc.index(videos)
    want = enc.search(qf, qm, k)
    del enc
    torch.cuda.empty_cache()
    for block in STREAM["blocks"]:
        r = Retriever(model, query_bsz=bsz, device=dev, index_store="raw",
                      stream_block=block)
        r.index(videos)
        got = r.search(qf, qm, k)
        del r
        same = bool(np.array_equal(got[1], want[1]))
        emit({"check": "raw_vs_encoded_exact", "dtype": "float32",
              "block": block, "queries": nq, "same_ids": same,
              "scores_max_abs_diff": float(np.abs(got[0] - want[0]).max())})
        if not same:
            fail(f"raw exact search f32 block {block}: ids differ from the "
                 f"encoded store's")
    del model
    torch.cuda.empty_cache()


def phase_streaming(dev, videos, queries):
    """Corpus streaming at TVR scale: the kernels at the streaming shapes,
    the streaming eval in three dtypes at two blocks, run_retrieval_eval
    under a memory budget, the raw-store search. Returns the kernel checks
    and each path's launch counts."""
    t0 = time.perf_counter()
    checks = _stream_kernel_checks(dev)
    launches = {}
    _stream_evals(dev, videos, queries, launches)
    _stream_under_budget(dev, videos, queries, launches)
    _raw_search(dev, videos, queries, launches)
    emit({"phase": "streaming", "seconds": time.perf_counter() - t0})
    return checks, launches


# ------------------------------------------------- slice 9: artifacts

# each store of the artifact phase: (name, Retriever keywords,
# DLDKD_DENSE_RESCORE, kernels of the search after the index is loaded)
ARTIFACT_STORES = (
    ("exact", {}, None, ("sim_max", "query_tower")),
    ("two_stage", {"score_quant": True}, "always",
     ("sim_max_int8", "sim_max_exact", "query_tower")),
    ("int8_only", {"score_quant": True, "rescore": False}, None,
     ("sim_max_int8", "query_tower")),
    ("raw", {"index_store": "raw", "stream_block": 2048}, None,
     ("sim_max", "query_tower", "context_tower")),
)
PREWARM = [(32, 10), (32, 100)]


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _q8t_kernel_check(dev) -> dict:
    """The int8 epilogue's transposed write (q8_transposed) at 2,048
    videos x 128 frames, both branches, in bf16 and f32: bitwise against
    its plain version (the plain epilogue of the same chain's frames,
    permuted to (L_p, Nv_p, H)) through the towers and alone, the pad bias
    against q8_index_bias's; the write alone timed beside the in-place
    epilogue on the same rows (bytes bound: read T, write int8)."""
    import torch

    from dldkd_tpu_torch.ops.fast_eval import tower_weights
    from dldkd_tpu_torch.ops.kernels import query_tower as qt
    from dldkd_tpu_torch.ops.kernels import sim_max

    gen = torch.Generator().manual_seed(31)
    nv, lf, h, d = max(STREAM["blocks"]), TVR["frames"], TVR["hidden"], \
        TVR["d_video"]
    x = torch.randn(nv - 5, lf, d, generator=gen)    # pads to 2,048 videos
    x = (x / x.norm(dim=-1, keepdim=True)).to(dev)
    xm = _ragged_mask(nv - 5, lf, 8, gen, dev)
    out = {}
    for dtype in ("bfloat16", "float32"):
        tdt = getattr(torch, dtype)
        item = torch.tensor([], dtype=tdt).element_size()
        ws = tower_weights(_serving_model(dtype, seed=32), dev)["context"]
        before = qt.LAUNCHES["context_tower_q8_t"]
        got = qt.fused_context_tower_dual(x, xm, *ws, TVR["heads"], tdt,
                                          emit_q8=True, q8_transposed=True)
        launches = qt.LAUNCHES["context_tower_q8_t"] - before
        l_p, nv_p = got[0].shape[:2]
        xp = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, nv_p - x.shape[0]))
        mp = torch.nn.functional.pad(xm, (0, 0, 0, nv_p - x.shape[0]))
        frames = qt.context_towers(xp, mp, ws, TVR["heads"], tdt, "check")
        torch.cuda.synchronize()
        want = [qt.q8_transposed_plain(qt.quantize_frames_q8_plain(f))
                for f in frames]
        bitwise = all(torch.equal(a, b) for a, b in zip(got, want))
        y = torch.stack(frames).view(2, nv_p * lf, h)
        t_out = torch.empty((2, l_p, nv_p, h), dtype=torch.int8, device=dev)
        y8 = torch.empty(y.shape, dtype=torch.int8, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        qt._launch_quantize_t(y, h, lf, t_out, 0, stream)
        torch.cuda.synchronize()
        alone = all(torch.equal(t_out[b], want[b]) for b in range(2))
        bias = sim_max.q8_index_bias(xm, l_p, nv_p)
        bias_ok = bool((bias[:, x.shape[0]:] == sim_max.INT8_MASK_BIAS)
                       .all()) and torch.equal(
            bias[:, :x.shape[0]], sim_max.q8_index_bias(xm).T)
        n_el = y.numel()
        b_ms, b_by = bound(n_el * item + n_el, 6 * n_el, "float32")
        rec = {"check": "context_tower_q8_t", "dtype": dtype,
               "shape": {"frames": [2, nv_p, lf, h], "out": [2, l_p, nv_p,
                                                             h]},
               "launches_per_call": launches, "bitwise": bitwise,
               "bitwise_alone": alone, "pad_bias_ok": bias_ok,
               "max_abs_err": max(max_err(a, b) for a, b in zip(got, want)),
               "tol": 0.0,
               "kernel_ms": cuda_ms(lambda: qt._launch_quantize_t(
                   y, h, lf, t_out, 0, stream)),
               "device_ms": device_ms(lambda: qt._launch_quantize_t(
                   y, h, lf, t_out, 0, stream)),
               "in_place_epilogue_ms": cuda_ms(lambda: qt._launch_quantize(
                   y, y8, stream)),
               "in_place_device_ms": device_ms(lambda: qt._launch_quantize(
                   y, y8, stream)),
               "plain_ms": cuda_ms(lambda: [
                   qt.q8_transposed_plain(qt.quantize_frames_q8_plain(f))
                   for f in frames], n=3, warmup=1),
               "tower_with_transposed_write_ms": cuda_ms(
                   lambda: qt.fused_context_tower_dual(
                       x, xm, *ws, TVR["heads"], tdt, emit_q8=True,
                       q8_transposed=True), n=3, warmup=1),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        rec["share_of_bound"] = b_ms / rec["device_ms"]
        rec["in_place_share_of_bound"] = b_ms / rec["in_place_device_ms"]
        emit(rec)
        out[dtype] = rec
        if not (bitwise and alone and bias_ok and launches == 1):
            fail(f"context_tower_q8_t {dtype}: transposed write vs plain: "
                 f"bitwise {bitwise}, alone {alone}, bias {bias_ok}, "
                 f"{launches} launches")
        del ws, got, want, frames, y, t_out, y8
        torch.cuda.empty_cache()
    return out


def _first_search_ms(model, path, qf, qm, dev, kw) -> tuple:
    """load_index of the artifact at path in a new Retriever, then the
    first search of one serving batch: (load s, first search ms)."""
    import torch

    from dldkd_tpu_torch.serving import Retriever

    bsz, k = SERVE["query_bsz"], SERVE["k"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = Retriever(model, query_bsz=bsz, device=dev, **kw)
    r.load_index(path, context_bsz=TVR["context_bsz"])
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    r.search(qf[:bsz], qm[:bsz], k)
    first_ms = (time.perf_counter() - t0) * 1e3
    del r
    torch.cuda.empty_cache()
    return load_s, first_ms


def phase_artifacts(dev, videos, queries):
    """Index artifacts at TVR scale and serving width (bf16, query batch
    256, k = 10) for four stores: index(), save_index, load_index in a new
    Retriever, whose ids and scores over every query must be bitwise the
    builder's; index against load seconds and the artifact's bytes on
    disk; for the exact store the memory that keeping the towers'
    unnormalized frames as well would cost (writing the JAX package's
    exact artifact byte for byte). Then a two-signature prewarm on the
    two-stage artifact (the first search after load_index with and without
    the manifest, in turns), and the towers' transposed int8 emission
    (q8_transposed) of the whole corpus against the int8-only artifact's
    rows. Returns each path's launch counts."""
    import numpy as np
    import torch

    from dldkd_tpu_torch.evaluate import embed_corpus
    from dldkd_tpu_torch.ops.kernels import query_tower as qt
    from dldkd_tpu_torch.ops.kernels import sim_max
    from dldkd_tpu_torch.serving import Retriever

    t_phase = time.perf_counter()
    model = _serving_model("bfloat16", seed=6)
    qf, qm = queries.feats, queries.mask
    nq, bsz, k = len(queries), SERVE["query_bsz"], SERVE["k"]
    launches = {}
    saved_mode = os.environ.get("DLDKD_DENSE_RESCORE")
    workdir = tempfile.mkdtemp(prefix="chip_smoke_artifacts_")
    try:
        for name, kw, mode, kernels in ARTIFACT_STORES:
            if mode is None:
                os.environ.pop("DLDKD_DENSE_RESCORE", None)
            else:
                os.environ["DLDKD_DENSE_RESCORE"] = mode
            path = os.path.join(workdir, name)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = Retriever(model, query_bsz=bsz, device=dev, **kw)
            r.index(videos, context_bsz=TVR["context_bsz"])
            torch.cuda.synchronize()
            index_s = time.perf_counter() - t0
            want = r.search(qf, qm, k)
            rec = {"phase": "artifacts", "store": name, "dtype": "bfloat16",
                   "videos": len(videos), "queries": nq, "query_bsz": bsz,
                   "k": k, "index_s": index_s}
            if name == "exact":
                # option (a): the towers' frames kept beside the normalized
                # ones, to write them as the JAX package does
                torch.cuda.synchronize()
                m0 = torch.cuda.memory_allocated()
                keep = embed_corpus(model, videos, TVR["context_bsz"], dev,
                                    r.weights)
                torch.cuda.synchronize()
                rec["unnormalized_frames_extra_bytes"] = \
                    torch.cuda.memory_allocated() - m0
                del keep
            t0 = time.perf_counter()
            r.save_index(path)
            rec["save_s"] = time.perf_counter() - t0
            rec["artifact_bytes"] = _dir_bytes(path)
            del r
            torch.cuda.empty_cache()
            _reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = Retriever(model, query_bsz=bsz, device=dev, **kw)
            r.load_index(path, context_bsz=TVR["context_bsz"])
            torch.cuda.synchronize()
            rec["load_s"] = time.perf_counter() - t0
            got = r.search(qf, qm, k)
            counts = _counts()
            launches[f"artifacts_{name}"] = counts
            rec.update(launches=counts,
                       same_ids=bool(np.array_equal(got[1], want[1])),
                       same_scores=bool(np.array_equal(got[0], want[0])),
                       finite=bool(np.isfinite(got[0]).all()))
            if name == "int8_only":
                # the towers' transposed int8 emission of the corpus: its
                # real rows are the artifact's, in the TPU scoring layout
                _reset_counts()
                ws = r.weights["context"]
                x = torch.from_numpy(videos.feats).to(dev)
                xm = torch.from_numpy(videos.mask).to(dev)
                t_rows = qt.fused_context_tower_dual(
                    x, xm, *ws, TVR["heads"], torch.bfloat16, emit_q8=True,
                    q8_transposed=True)
                torch.cuda.synchronize()
                counts = _counts()
                launches["artifacts_q8_transposed"] = counts
                n = len(videos)
                diffs = [(t[:, :n].int() - a[:n].permute(1, 0, 2).int())
                         .abs() for t, a in zip(t_rows, (r.q8_inher,
                                                         r.q8_explore))]
                l_p, nv_p = t_rows[0].shape[:2]
                rec["q8_transposed"] = {
                    "shape": list(t_rows[0].shape), "launches": counts,
                    "share_equal": float(sum((t == 0).sum() for t in diffs))
                    / sum(t.numel() for t in diffs),
                    "max_levels": int(max(t.max() for t in diffs)),
                    "bias_matches": bool(torch.equal(
                        sim_max.q8_index_bias(xm, l_p, nv_p)[:, :n],
                        r.q8_bias[:n].T))}
                _check_launched(counts, ("context_tower_q8_t",),
                                "artifacts q8_transposed")
                del x, xm, t_rows, diffs
            emit(rec)
            _check_launched(launches[f"artifacts_{name}"], kernels,
                            f"artifacts {name} after load_index")
            if not (rec["same_ids"] and rec["same_scores"] and rec["finite"]):
                fail(f"artifacts {name}: the loaded index's results differ "
                     f"from the builder's (ids {rec['same_ids']}, scores "
                     f"{rec['same_scores']})")
            if name == "int8_only" and (
                    rec["q8_transposed"]["max_levels"] > 1
                    or not rec["q8_transposed"]["bias_matches"]):
                fail(f"artifacts: the transposed int8 emission is off the "
                     f"artifact's rows: {rec['q8_transposed']}")
            if name == "two_stage":
                kw2 = kw
            del r
            torch.cuda.empty_cache()

        # prewarm: the two-stage artifact with a two-signature manifest
        os.environ["DLDKD_DENSE_RESCORE"] = "always"
        r = Retriever(model, query_bsz=bsz, device=dev, **kw2)
        r.load_index(os.path.join(workdir, "two_stage"),
                     context_bsz=TVR["context_bsz"])
        t0 = time.perf_counter()
        pw_path = os.path.join(workdir, "two_stage_prewarm")
        r.save_index(pw_path, prewarm=PREWARM)
        prewarm_save_s = time.perf_counter() - t0
        del r
        torch.cuda.empty_cache()
        turns = []
        for with_manifest in (False, True, False, True):
            load_s, first_ms = _first_search_ms(
                model, pw_path if with_manifest else
                os.path.join(workdir, "two_stage"), qf, qm, dev, kw2)
            turns.append({"manifest": with_manifest, "load_s": load_s,
                          "first_search_ms": first_ms})
        emit({"phase": "artifacts_prewarm", "store": "two_stage",
              "signatures": [[bsz, lq, kk] for lq, kk in PREWARM],
              "save_with_prewarm_s": prewarm_save_s, "turns": turns})
    finally:
        import shutil

        shutil.rmtree(workdir, ignore_errors=True)
        if saved_mode is None:
            os.environ.pop("DLDKD_DENSE_RESCORE", None)
        else:
            os.environ["DLDKD_DENSE_RESCORE"] = saved_mode
    del model
    torch.cuda.empty_cache()
    emit({"phase": "artifacts", "seconds": time.perf_counter() - t_phase})
    return launches


# ----------------------------------------- slice 13: multi-GPU, parallel/

# the sharded eval's routes: (name, dtype, score_quant, corpus_stream_bsz
# (-1 resident), kernels of the path)
# the one-card mesh's shards; the streaming routes' corpus block; the
# world-of-one run's dataset (train.main at phase_train's widths: 2 steps
# of 128, then validation and inference)
PARALLEL = dict(shards=2, block=512, n_train=256, n_val=100, n_test=100)
PARALLEL_ROUTES = (
    ("resident bf16", "bfloat16", False, -1, _eval_kernels("bfloat16")),
    ("resident f32", "float32", False, -1, _eval_kernels("float32")),
    (f"streaming {PARALLEL['block']} bf16", "bfloat16", False,
     PARALLEL["block"], _eval_kernels("bfloat16")),
    ("resident int8", "bfloat16", True, -1, INT8_EVAL_KERNELS),
    (f"streaming {PARALLEL['block']} int8", "bfloat16", True,
     PARALLEL["block"], INT8_EVAL_KERNELS),
)


def _timed_eval(model, videos, queries, cfg, mesh, dev) -> dict:
    """run_retrieval_eval on one device (mesh None) or a mesh: metrics,
    wall seconds, peak memory and launches."""
    import torch

    from dldkd_tpu_torch.evaluate import run_retrieval_eval

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    metrics = run_retrieval_eval(model, videos, queries, cfg, mesh=mesh,
                                 device=dev)
    torch.cuda.synchronize()
    return {"seconds": time.perf_counter() - t0, "metrics": metrics,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "launches": _counts()}


def _sharded_evals(mesh, mesh_name, videos, queries, dev, launches) -> None:
    """Each route of PARALLEL_ROUTES through run_retrieval_eval on one
    device and on `mesh`, in turns: every metric equal, the mesh's
    kernels launched; then the sharded score matrices against the
    single-device engine's (`eval_shard.sharded_score_matrices` against
    `score_matrices` / `stream_score_matrices`)."""
    import torch

    from dldkd_tpu_torch.config import EvalConfig
    from dldkd_tpu_torch.evaluate import score_matrices, stream_score_matrices
    from dldkd_tpu_torch.parallel.eval_shard import sharded_score_matrices

    nv = len(videos)
    for name, dtype, quant, stream, kernels in PARALLEL_ROUTES:
        model = _serving_model(dtype, seed=6)
        cfg = EvalConfig(eval_query_bsz=TVR["query_bsz"],
                         eval_context_bsz=TVR["context_bsz"],
                         corpus_stream_bsz=stream, score_quant=quant)
        what = f"sharded eval {name}, {mesh_name}"
        runs = {tag: _timed_eval(model, videos, queries, cfg, m, dev)
                for tag, m in (("single", None), ("sharded", mesh))}
        sharded = runs["sharded"]
        _check_metrics(sharded["metrics"], what)
        _check_launched(sharded["launches"], kernels, what)
        if sharded["metrics"] != runs["single"]["metrics"]:
            fail(f"{what}: metrics {sharded['metrics']} differ from the "
                 f"single-device eval's {runs['single']['metrics']}")
        # the scores at the single-device engine's query batch (resident
        # 50, streaming 64), and at the mesh route's 64
        if stream > 0:
            ref = stream_score_matrices(model, videos, queries, stream,
                                        64, dev, score_quant=quant)
        else:
            ref = score_matrices(model, videos, queries, TVR["context_bsz"],
                                 TVR["query_bsz"], dev, score_quant=quant)
        ref = [r[:, :nv] for r in ref]
        diffs = {}
        for bsz in dict.fromkeys((64 if stream > 0 else TVR["query_bsz"],
                                  64)):
            got = sharded_score_matrices(model, videos, queries, mesh,
                                         query_bsz=bsz, score_quant=quant,
                                         corpus_block=max(stream, 0),
                                         context_bsz=TVR["context_bsz"])
            diffs[bsz] = {
                "max_abs_err": max(max_err(g, r) for g, r in zip(got, ref)),
                "bitwise": all(torch.equal(g, r) for g, r in zip(got, ref))}
            del got
        tol = TOL[("scores", dtype)]
        emit({"phase": "parallel_eval", "route": name, "mesh": mesh_name,
              "shards": mesh.size, "videos": nv, "queries": len(queries),
              "single": runs["single"], "sharded": sharded,
              "sharded_vs_single_wall": sharded["seconds"]
              / runs["single"]["seconds"],
              "scores_vs_single_by_query_bsz": diffs, "tol": tol})
        for bsz, d in diffs.items():
            if not d["max_abs_err"] <= tol:
                fail(f"{what}: scores at query batch {bsz} differ from the "
                     f"single-device engine's by {d['max_abs_err']} > {tol}")
        launches[f"{name}, {mesh_name}"] = sharded["launches"]
        del model, ref
        torch.cuda.empty_cache()


def _one_branch_sharded(mesh, videos, queries, dev, launches) -> None:
    """The workload's one-branch twin (`tools/workload.py`'s
    serving_model(one_branch_of=...)) through the sharded resident eval:
    the one-branch towers launch, the corpus is scored once per shard and
    query batch, the metrics are the single-device eval's."""
    from dldkd_tpu_torch.config import EvalConfig
    from dldkd_tpu_torch.tools import workload

    twin = workload.serving_model(one_branch_of=_serving_model("bfloat16",
                                                               seed=6))
    cfg = EvalConfig(eval_query_bsz=TVR["query_bsz"],
                     eval_context_bsz=TVR["context_bsz"],
                     corpus_stream_bsz=-1)
    single = _timed_eval(twin, videos, queries, cfg, None, dev)
    sharded = _timed_eval(twin, videos, queries, cfg, mesh, dev)
    counts = sharded["launches"]
    what = "sharded eval, one-branch twin"
    _check_launched(counts, ("query_tower_1br", "context_tower_1br",
                             "sim_max_bf16"), what)
    want_scores = mesh.size * -(-len(queries) // max(TVR["query_bsz"], 64))
    emit({"phase": "parallel_eval_1br", "shards": mesh.size,
          "single": single, "sharded": sharded,
          "scorer_launches_want": want_scores})
    if set(sharded["metrics"]) != {"inher", "fused"} \
            or sharded["metrics"] != single["metrics"]:
        fail(f"{what}: metrics {sharded['metrics']} vs the single-device "
             f"eval's {single['metrics']}")
    if counts["sim_max"] != want_scores:
        fail(f"{what}: {counts['sim_max']} scorer launches, want "
             f"{want_scores} (one per shard and query batch)")
    launches[f"resident bf16 one-branch, {mesh.size} shards on {dev}"] = \
        counts


def _parallel_shape_checks(dev, videos, queries, mesh) -> dict:
    """The kernels of the sharded evals at the shapes that path gives
    them, on the path's own data and models (`_serving_model(dtype, 6)`,
    its one-branch twin, shard 0 of `mesh`): the query towers at the mesh
    route's batch of 64 queries (two branches in both dtypes, one on the
    twin); the video towers on one streaming block of a shard
    (PARALLEL["block"] / shard count videos; two branches, both dtypes)
    and on the twin's resident context batch; the int8 epilogue on that
    block (bitwise against its plain version on the same frames); each
    scorer of the 64 queries against shard 0's resident index, as the
    resident engine builds it in context batches (bf16 and f32 frames;
    the int8 index with every valid column bitwise). Each against its
    plain version at the TOL values; returns each record by name."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from dldkd_tpu_torch.data.ingest import PackedVideos
    from dldkd_tpu_torch.evaluate import embed_corpus
    from dldkd_tpu_torch.ops.fast_eval import (encode_context_best,
                                               encode_context_q8,
                                               encode_query_best,
                                               tower_weights)
    from dldkd_tpu_torch.ops.kernels import query_tower as qt
    from dldkd_tpu_torch.ops.kernels import sim_max
    from dldkd_tpu_torch.ops.masking import l2_normalize
    from dldkd_tpu_torch.ops.similarity import clip_scores_maxpool_pre8
    from dldkd_tpu_torch.parallel.mesh import shard_rows
    from dldkd_tpu_torch.tools import workload

    nq, h, cb = max(TVR["query_bsz"], 64), TVR["hidden"], TVR["context_bsz"]
    rows = shard_rows(len(videos), mesh)[0]
    shard = PackedVideos(videos.feats[rows], videos.mask[rows],
                         videos.ids[rows])
    block = -(-PARALLEL["block"] // mesh.size)

    def on_dev(a, n):
        return torch.from_numpy(np.ascontiguousarray(a[:n])).to(dev)

    qf, qm = on_dev(queries.feats, nq), on_dev(queries.mask, nq)
    vf, vm = on_dev(shard.feats, block), on_dev(shard.mask, block)
    lf = vf.shape[1]
    out = {}

    def tower(model, ws, dtype, kind, x, m, shapes_of):
        enc = encode_query_best if kind == "query" else encode_context_best
        l = x.shape[1]
        lp = -(-l // 8) * 8
        xp, mp = F.pad(x, (0, 0, 0, lp - l)), F.pad(m, (0, lp - l))
        packed = ws["packed"][kind][0]
        return _tower_check(
            kind, dtype, len(model.branches), tuple(x.shape), lp, packed,
            lambda: [t for t in enc(model, x, m, ws) if t is not None],
            lambda: [t for t in enc(model, x, m, ws, plain=True)
                     if t is not None],
            lambda: qt.tower_cuda(xp, mp, packed, TVR["heads"],
                                  getattr(torch, dtype), kind, pos_rows=l),
            n_plain=5, shapes_of=shapes_of)

    def scorer(dtype, entry, run, plain, launch, q, c, per_frame, nv_real,
               tol):
        got, want = run(), plain()
        torch.cuda.synchronize()
        nvp, item = c.shape[0], c.element_size()
        n_bytes = (q.numel() * q.element_size() + nvp * lf * h * item
                   + nvp * lf * 4 + nq * nvp * 4)
        arith, passes = {"bfloat16": ("bfloat16", 1), "float32": ("tf32", 3),
                         "int8": ("int8", 1)}[dtype]
        b_ms, b_by = bound(n_bytes, passes * 2 * nq * nvp * lf * h, arith)
        rec = {"check": "parallel_scorer", "kernel": entry, "dtype": dtype,
               "shape": {"q": [nq, h], "ctx": [nvp, lf, h]},
               "max_abs_err": max_err(got[:, :nv_real], want[:, :nv_real]),
               "tol": tol,
               "bitwise_valid_columns": bool(torch.equal(
                   got[:, :nv_real], want[:, :nv_real])),
               "kernel_ms": cuda_ms(scoring_launch(entry, q, c, *per_frame)),
               "wrapper_ms": cuda_ms(run), "plain_ms": cuda_ms(plain, n=5),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
               "shapes_of": "sharded resident: a query batch against "
                            "shard 0's index"}
        emit(rec)
        if not rec["max_abs_err"] <= tol:
            fail(f"sharded eval {entry}: {nq} queries x shard 0: max abs "
                 f"error {rec['max_abs_err']} > {tol}")
        return rec

    for dtype in ("bfloat16", "float32"):
        model = _serving_model(dtype, seed=6)
        ws = tower_weights(model, dev)
        out[f"query_tower_{dtype}"] = tower(
            model, ws, dtype, "query", qf, qm,
            "sharded eval: the mesh route's query batch")
        out[f"context_tower_{dtype}"] = tower(
            model, ws, dtype, "context", vf, vm,
            f"sharded streaming: a block of {block} per shard")
        q_i = encode_query_best(model, qf, qm, ws)[0]
        c_i, _, cmask = embed_corpus(model, shard, cb, dev, ws)
        qn, cn = l2_normalize(q_i).contiguous(), l2_normalize(c_i).contiguous()
        del c_i
        cmask = cmask.float().contiguous()
        entry = "sim_max_f32" if dtype == "float32" else "sim_max_bf16"
        out[f"sim_max_{dtype}"] = scorer(
            dtype, entry, lambda: sim_max.fused_clip_scores(qn, cn, cmask),
            lambda: sim_max.sim_max_plain(qn, cn, cmask), entry, qn, cn,
            (cmask,), len(shard), TOL[("sim_max", dtype)])
        del cn
        if dtype == "bfloat16":
            # the int8 route: the epilogue on the streaming block, the
            # scorer on shard 0's prebuilt index
            k8 = encode_context_q8(model, vf, vm, ws)
            kf = encode_context_best(model, vf, vm, ws)
            torch.cuda.synchronize()
            rec = {"check": "parallel_context_tower_q8", "dtype": dtype,
                   "shape": {"frames": [len(k8), *kf[0].shape]},
                   "max_abs_err": max(
                       max_err(a, qt.quantize_frames_q8_plain(f))
                       for a, f in zip(k8, kf)),
                   "tol": TOL[("context_tower_q8", dtype)],
                   "bitwise": all(
                       torch.equal(a, qt.quantize_frames_q8_plain(f))
                       for a, f in zip(k8, kf)),
                   "shapes_of": f"sharded streaming int8: a block of "
                                f"{block} per shard"}
            del k8, kf
            emit(rec)
            out["context_tower_q8"] = rec
            if not rec["bitwise"]:
                fail(f"sharded eval int8 epilogue: {rec}")
            i8, _, bias = embed_corpus(model, shard, cb, dev, ws,
                                       score_quant=True)
            q8 = sim_max.quantize_unit_int8(qn).contiguous()
            out["sim_max_int8"] = scorer(
                "int8", "sim_max_int8",
                lambda: clip_scores_maxpool_pre8(q_i, i8, bias),
                lambda: clip_scores_maxpool_pre8(q_i, i8, bias, plain=True),
                "sim_max_int8", q8, i8, (bias,), len(shard),
                TOL[("sim_max_int8", "int8")])
            if not out["sim_max_int8"]["bitwise_valid_columns"]:
                fail("sharded eval int8 scorer: valid columns differ from "
                     "the plain version")
            del i8, bias, q8
            twin = workload.serving_model(device=dev, one_branch_of=model)
            tws = tower_weights(twin, dev)
            out["query_tower_1br"] = tower(
                twin, tws, dtype, "query", qf, qm,
                "sharded eval, one-branch twin: the mesh route's query "
                "batch")
            out["context_tower_1br"] = tower(
                twin, tws, dtype, "context", vf[:cb], vm[:cb],
                "sharded resident, one-branch twin: a context batch")
            del twin, tws
        del model, ws, q_i, qn, cmask
        torch.cuda.empty_cache()
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class _LogLines(logging.Handler):
    """Collects the port's log messages while attached."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _dp_step_timing(dev, group) -> dict:
    """The data-parallel step in `group` (a world of one) against the
    single-device step on _dp_batch(), in turns after one warm-up step
    each: synchronized wall ms (median of DP_GLOO["timed_steps"]), then
    device-busy ms and CUDA kernels per step over 3 profiled steps."""
    import statistics

    import torch

    from dldkd_tpu_torch.tools.train_bench import profile_step

    steps = {"single": _dp_stepper(False, dev)[0],
             "data_parallel": _dp_stepper(False, dev, group)[0]}
    for step in steps.values():
        step()
    wall = {tag: [] for tag in steps}
    for _ in range(DP_GLOO["timed_steps"]):
        for tag, step in steps.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall[tag].append((time.perf_counter() - t0) * 1e3)
    return {tag: {"step_ms_median": statistics.median(wall[tag]),
                  "step_ms_all": wall[tag], **profile_step(step, 3)}
            for tag, step in steps.items()}


def _train_world_of_one(workdir: str, dev, launches) -> None:
    """`python -m dldkd_tpu_torch.train`'s main in this process as an NCCL
    world of one (torchrun's variables set here, restored after): the
    data-parallel path (the autograd gather and the gradient all-reduce
    on NCCL, the validation and the test inference on the process-group
    mesh) for one epoch at phase_train's widths."""
    import torch
    import torch.distributed as dist

    from dldkd_tpu_torch import train
    from dldkd_tpu_torch.data.synthetic import generate_dataset

    root = os.path.join(workdir, "dp_data")
    generate_dataset(root, n_videos={"train": PARALLEL["n_train"],
                                     "val": PARALLEL["n_val"],
                                     "test": PARALLEL["n_test"]},
                     frames_range=(20, 200), tokens_range=(5, 31),
                     d_student=TRAIN["d_video"], d_query=TRAIN["d_query"],
                     d_teacher=TRAIN["d_teacher"], seed=8,
                     noise=TRAIN["noise"], feature_format="npz")
    res = os.path.join(workdir, "dp_run")
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    log = _LogLines()
    logger = logging.getLogger("dldkd_tpu_torch")
    logger.addHandler(log)
    _reset_counts()
    try:
        with _PlainCalls() as plain:
            t0 = time.perf_counter()
            test_metrics = train.main(TRAIN_ARGS + [
                "--root_path", root, "--results_root", res,
                "--n_epoch", "1"])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        counts = _counts()   # train.main's alone, before the step timing
        backend = dist.get_backend() if dist.is_initialized() else None
        world = dist.get_world_size() if dist.is_initialized() else None
        timing = (_dp_step_timing(dev, dist.group.WORLD)
                  if backend else None)
    finally:
        logger.removeHandler(log)
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    run_dir = _run_dir(res)
    steps, sumrs, epochs = _train_history(run_dir)
    dp_lines = [x for x in log.lines if x.startswith("data-parallel")]
    emit({"phase": "parallel_train_world_of_one", "seconds": secs,
          "backend": backend, "world_size": world, "log": dp_lines,
          "step_timing": timing,
          "steps": len(steps), "epochs_logged": epochs,
          "val_fused_sumr": sumrs,
          "loss_overall": [r["Train/loss_overall"] for r in steps],
          "launches": counts, "plain_calls": plain.calls,
          "test_metrics": test_metrics})
    what = "train.main, NCCL world of one"
    if backend != "nccl" or world != 1:
        fail(f"{what}: process group {backend} of {world}")
    if dp_lines != ["data-parallel: 1 of 1 devices / 1 processes"]:
        fail(f"{what}: data-parallel log lines {dp_lines}")
    _check_losses(steps, what)
    _check_launched(counts, TRAIN_KERNELS, what)
    if plain.calls:
        fail(f"{what}: the eval path on the card ran plain versions "
             f"{plain.calls}")
    if not os.path.isfile(os.path.join(run_dir, "ckpt", "model.ckpt")):
        fail(f"{what}: no checkpoint in {run_dir}")
    if epochs != [0] or len(sumrs) != 1 \
            or len(steps) != PARALLEL["n_train"] // TRAIN["bsz"]:
        fail(f"{what}: epochs {epochs}, {len(sumrs)} validations, "
             f"{len(steps)} steps")
    if test_metrics is None:
        fail(f"{what}: no post-train test metrics")
    _check_metrics(test_metrics, f"{what}, test split")
    for tag, t in timing.items():
        _check_times([t["step_ms_median"], t["device_busy_ms_per_step"]],
                     f"{what}: the {tag} step")
    launches["train.main NCCL world of one"] = counts


# the gloo ranks' step: phase_train's widths and do_tvr.sh's dropout, a
# loader-shaped batch of 128 videos and 256 captions, hard negatives from
# the default pool; held (as tests/test_torch_parallel.py holds the CPU
# step): losses within rtol 2e-4, parameters within rtol 2e-4 + 1e-6
DP_GLOO = dict(videos=128, queries=256, seed=13, rtol=2e-4, atol=1e-6,
               timed_steps=10)


def _dp_setting(stacked: bool):
    from dldkd_tpu_torch.config import ModelConfig, TrainConfig

    mcfg = ModelConfig(
        visual_input_size=TRAIN["d_video"], query_input_size=TRAIN["d_query"],
        inheritance_hidden=384, exploration_hidden=384, max_ctx_l=128,
        max_desc_l=30, n_heads=4, double_branch=True, label_style="soft",
        drop=0.2, input_drop=0.2, margin=0.1, use_hard_negative=True)
    return mcfg, TrainConfig(lr=3e-4, stacked_towers=stacked)


def _dp_batch():
    """A loader-shaped host batch: videos by caption count, captions
    video-major with label -1 padding, ragged masks."""
    import numpy as np

    rng = np.random.RandomState(DP_GLOO["seed"])
    b, q = DP_GLOO["videos"], DP_GLOO["queries"]
    caps = np.sort(rng.randint(1, 3, b))[::-1]
    n_q = int(caps.sum())
    labels = np.full(q, -1, np.int32)
    labels[:n_q] = np.repeat(np.arange(b), caps)
    vmask = (np.arange(128)[None] < rng.randint(20, 129, b)[:, None]
             ).astype(np.float32)
    tmask = (np.arange(30)[None] < rng.randint(5, 31, q)[:, None]
             ).astype(np.float32)
    tmask[n_q:] = 0
    f32 = np.float32
    return {
        "student_videos": rng.randn(b, 128, TRAIN["d_video"]).astype(f32)
        * vmask[..., None],
        "student_videos_mask": vmask,
        "teacher_videos": rng.randn(b, 128, TRAIN["d_teacher"]).astype(f32)
        * vmask[..., None],
        "student_text": rng.randn(q, 30, TRAIN["d_query"]).astype(f32)
        * tmask[..., None],
        "student_text_mask": tmask,
        "teacher_text": rng.randn(q, TRAIN["d_teacher"]).astype(f32),
        "text_labels": labels}


def _dp_stepper(stacked: bool, dev, group=None) -> tuple:
    """(step, model): step() runs one step of `model` (seeded weights) on
    _dp_batch(), the data-parallel step over `group`, else the
    single-device step, and returns its loss dict."""
    import functools

    import torch

    from dldkd_tpu_torch import train
    from dldkd_tpu_torch.models import DLDKD
    from dldkd_tpu_torch.models.objective import LossScalars
    from dldkd_tpu_torch.optim import BertAdam, default_wd_mask
    from dldkd_tpu_torch.parallel import (make_dp_train_step, make_mesh,
                                          shard_batch_multihost)

    mcfg, tcfg = _dp_setting(stacked)
    model = DLDKD(mcfg).init_weights(torch.Generator().manual_seed(3))
    model.to(dev).train()
    named = dict(model.named_parameters())
    opt = BertAdam(named, tcfg.lr, None, wd_mask=default_wd_mask(named))
    batch = _dp_batch()
    if group is None:
        step = functools.partial(train.train_step, model, mcfg, tcfg, opt)
    else:
        batch = shard_batch_multihost(batch, group)
        step = make_dp_train_step(model, mcfg, tcfg, opt,
                                  make_mesh(devices=[dev], group=group))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    scalars = LossScalars(*(torch.tensor(v, device=dev)
                            for v in (0.9, 0.8, 0.7)))
    gen = torch.Generator(device=dev).manual_seed(11)
    return (lambda: step(batch, gen, scalars)), model


def _dp_step(stacked: bool, dev, group=None) -> tuple:
    """One step of _dp_stepper's: (losses, parameters on the CPU,
    seconds)."""
    import torch

    step, model = _dp_stepper(stacked, dev, group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = step()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return ({k: float(v) for k, v in losses.items()},
            {k: v.detach().cpu() for k, v in model.state_dict().items()},
            secs)


def _gloo_dp_rank(rank: int, port: str) -> None:
    """One of two gloo ranks sharing cuda:0 (`chip_smoke.py --dp-rank R
    PORT`): the data-parallel step plain and stacked; rank 0 also runs the
    single-device step and compares. Prints one JSON line."""
    import torch
    import torch.distributed as dist

    from dldkd_tpu_torch.models import DLDKD

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    out = {"rank": rank, "backend": dist.get_backend()}
    try:
        for stacked in (False, True):
            losses, params, secs = _dp_step(stacked, dev, dist.group.WORLD)
            rec = {"losses": losses, "seconds": secs,
                   "checksum": float(sum(p.double().abs().sum()
                                         for p in params.values()))}
            if rank == 0:
                want, want_p, want_s = _dp_step(stacked, dev)
                rec["single_losses"], rec["single_seconds"] = want, want_s
                rec["losses_max_rel_err"] = max(
                    abs(losses[k] - v) / max(abs(v), 1e-12)
                    for k, v in want.items())
                rec["params_max_abs_err"] = max(
                    float((params[k] - v).abs().max())
                    for k, v in want_p.items())
                rec["params_over_tol"] = sum(
                    int(((params[k] - v).abs() > DP_GLOO["atol"]
                         + DP_GLOO["rtol"] * v.abs()).sum())
                    for k, v in want_p.items())
                init = DLDKD(_dp_setting(stacked)[0]).init_weights(
                    torch.Generator().manual_seed(3)).state_dict()
                rec["update_max_abs"] = max(
                    float((v - init[k]).abs().max())
                    for k, v in want_p.items())
            out["stacked" if stacked else "plain"] = rec
    finally:
        dist.destroy_process_group()
    print(json.dumps(out), flush=True)


def _gloo_dp_on_one_card() -> None:
    """Two gloo ranks sharing cuda:0 (gloo takes CUDA tensors; NCCL
    refuses two ranks on one device): the data-parallel step equals the
    single-device step, plain and stacked, and both ranks end equal. A
    second pair of ranks, on a fresh port, runs only when the first lost
    the race for its port (the store's bind failed: the port was free
    when `_free_port` closed it); any other failure fails the phase.
    Every failed attempt's error is emitted."""
    script = os.path.abspath(__file__)
    for attempt in range(2):
        port = str(_free_port())
        procs = [subprocess.Popen(
            [sys.executable, script, "--dp-rank", str(r), port],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=os.path.dirname(script)) for r in range(2)]
        results, err = [], ""
        for p in procs:
            try:
                o, e = p.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                p.kill()
                o, e = p.communicate()
            if p.returncode:
                err += f"rank exit {p.returncode}: {e[-1500:]}"
            else:
                results.append(json.loads(o.strip().splitlines()[-1]))
        if not err:
            break
        emit({"phase": "parallel_gloo_dp_step", "attempt": attempt,
              "port": port, "error": err})
        if "EADDRINUSE" not in err and "address already in use" not in err:
            break
    if err or len(results) != 2:
        fail(f"gloo data-parallel step on one card: {err}")
    r0, r1 = sorted(results, key=lambda r: r["rank"])
    emit({"phase": "parallel_gloo_dp_step", "ranks": [r0, r1],
          "rtol": DP_GLOO["rtol"], "atol": DP_GLOO["atol"]})
    for key in ("plain", "stacked"):
        what = f"gloo data-parallel step ({key}) on one card"
        if r0[key]["losses"] != r1[key]["losses"] \
                or r0[key]["checksum"] != r1[key]["checksum"]:
            fail(f"{what}: the ranks differ")
        if r0[key]["losses_max_rel_err"] > DP_GLOO["rtol"] \
                or r0[key]["params_over_tol"]:
            fail(f"{what}: against the single-device step, losses "
                 f"{r0[key]['losses_max_rel_err']} (rel), "
                 f"{r0[key]['params_over_tol']} parameters past the "
                 f"tolerance")


def phase_parallel(workdir: str, dev, videos, queries) -> tuple:
    """Multi-GPU on one card (parallel/): the corpus-sharded eval on a
    mesh of two shards on `dev` (and over every GPU when there are
    several) on each route, against the single-device eval; the one-branch
    twin sharded; train.main as an NCCL world of one; the data-parallel
    step of two gloo ranks sharing the card against the single-device
    step. First each kernel of the sharded evals against its plain
    version at that path's shapes (`_parallel_shape_checks`). Returns
    (each path's launch counts, those checks by name)."""
    import torch

    from dldkd_tpu_torch.parallel import make_mesh

    t0 = time.perf_counter()
    launches = {}
    mesh = make_mesh(devices=[dev] * PARALLEL["shards"])
    checks = _parallel_shape_checks(dev, videos, queries, mesh)
    _sharded_evals(mesh, f"{mesh.size} shards on {dev}", videos, queries,
                   dev, launches)
    if torch.cuda.device_count() > 1:
        every = make_mesh()
        _sharded_evals(every, f"{every.size} GPUs", videos, queries, dev,
                       launches)
    _one_branch_sharded(mesh, videos, queries, dev, launches)
    _train_world_of_one(workdir, dev, launches)
    _gloo_dp_on_one_card()   # plain autograd: launches no kernel
    emit({"phase": "parallel", "seconds": time.perf_counter() - t0})
    return launches, checks


# ------------------------------------------- slice 14: serving on a mesh

# each route of the mesh serving phase: (name, Retriever keywords,
# DLDKD_DENSE_RESCORE pinned on both sides, kernels of the path, scorer
# counters with their launches per branch and per batch and shard (raw:
# per block) in one search)
SERVE_MESH_BLOCK = 2048
SERVE_MESH_ROUTES = (
    ("exact", {}, None, ("sim_max_bf16", "query_tower", "context_tower"),
     {"sim_max_bf16": 1}),
    ("two_stage_dense", {"score_quant": True}, "always",
     ("sim_max_int8", "sim_max_exact", "query_tower", "context_tower",
      "context_tower_q8"), {"sim_max_int8": 1, "sim_max_exact": 1}),
    ("two_stage_gather", {"score_quant": True}, "never",
     ("sim_max_int8", "query_tower", "context_tower", "context_tower_q8"),
     {"sim_max_int8": 1, "sim_max_exact": 0}),
    ("int8_only", {"score_quant": True, "rescore": False}, None,
     INT8_EVAL_KERNELS, {"sim_max_int8": 1}),
    (f"raw {SERVE_MESH_BLOCK} exact", {"index_store": "raw"}, None,
     ("sim_max_bf16", "query_tower", "context_tower"), {"sim_max_bf16": 1}),
    (f"raw {SERVE_MESH_BLOCK} two_stage",
     {"index_store": "raw", "score_quant": True}, "always",
     ("sim_max_int8", "sim_max_exact", "query_tower", "context_tower"),
     {"sim_max_int8": 1, "sim_max_exact": 1}),
    (f"raw {SERVE_MESH_BLOCK} int8_only",
     {"index_store": "raw", "score_quant": True, "rescore": False}, None,
     ("sim_max_int8", "query_tower", "context_tower"), {"sim_max_int8": 1}),
)


def _pin_dense_rescore(mode) -> None:
    if mode is None:
        os.environ.pop("DLDKD_DENSE_RESCORE", None)
    else:
        os.environ["DLDKD_DENSE_RESCORE"] = mode


def _served(model, videos, queries, dev, mesh, kw, plain=False,
            n_queries=None) -> dict:
    """A Retriever on `dev` (mesh None) or on `mesh`: index, one warm-up
    batch, then one timed search of the queries; the results, walls,
    queries/s, peak memory, the launches of the whole path (counts set to
    0 before the index) and of the timed search alone."""
    import torch

    from dldkd_tpu_torch.serving import Retriever

    bsz, k = SERVE["query_bsz"], SERVE["k"]
    qf, qm = queries.feats[:n_queries], queries.mask[:n_queries]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    r = Retriever(model, query_bsz=bsz, device=dev, mesh=mesh, plain=plain,
                  stream_block=SERVE_MESH_BLOCK, **kw)
    r.index(videos, context_bsz=TVR["context_bsz"])
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    at_index = _counts()
    r.search(qf[:bsz], qm[:bsz], k)                       # warm-up
    before = _counts()
    t0 = time.perf_counter()
    scores, idx = r.search(qf, qm, k)
    search_s = time.perf_counter() - t0
    counts = _counts()
    out = {"scores": scores, "ids": idx, "index_s": index_s,
           "search_s": search_s, "queries_per_s": len(qf) / search_s,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "launches": counts, "index_launches": at_index,
           "search_launches": {c: counts[c] - before[c] for c in counts},
           "live_shards": len(r._live()) if mesh is not None else 1,
           "blocks": (sum(-(-sh.real // SERVE_MESH_BLOCK)
                          for sh in r._live()) if mesh is not None
                      else -(-len(videos) // SERVE_MESH_BLOCK))}
    del r
    torch.cuda.empty_cache()
    return out


def _mesh_route(model, name, kw, mode, kernels, scorers, mesh, mesh_name,
                single, videos, queries, dev, launches) -> None:
    """One route on `mesh` against the single-device run `single` of the
    same route: ids equal and scores within TOL["dense_vs_gather"], the
    path's kernels launched with no plain version run, the launches per
    search as the layout implies, then the mesh's kernel path against its
    plain path on SERVE["plain_queries"] queries."""
    import numpy as np

    what = f"serving {name}, {mesh_name}"
    with _PlainCalls() as plain_calls:
        got = _served(model, videos, queries, dev, mesh, kw)
    _check_launched(got["launches"], kernels, what)
    if plain_calls.calls:
        fail(f"{what}: plain versions ran: {plain_calls.calls}")
    batches = -(-len(queries) // SERVE["query_bsz"])
    units = got["blocks"] if "index_store" in kw else \
        batches * got["live_shards"]
    want = {c: 2 * per * units for c, per in scorers.items()}
    # the queries once per batch; the video towers only on raw blocks
    want["query_tower"] = batches
    want["context_tower"] = got["blocks"] if "index_store" in kw else 0
    search = got["search_launches"]
    tie_tol = TOL[("dense_vs_gather", "scores")]
    same = bool(np.array_equal(got["ids"], single["ids"]))
    err = float(np.abs(got["scores"] - single["scores"]).max())
    npl = SERVE["plain_queries"]
    ref = _served(model, videos, queries, dev, mesh, kw, plain=True,
                  n_queries=npl)
    plain_err = float(np.abs(got["scores"][:npl] - ref["scores"]).max())
    flips = ~np.all(got["ids"][:npl] == ref["ids"], axis=1)
    emit({"phase": "serving_mesh", "route": name, "mesh": mesh_name,
          "shards": mesh.size, "live_shards": got["live_shards"],
          "dense_rescore_mode": mode or "auto",
          "stage2": ("dense" if search.get("sim_max_exact") else "gather")
          if kw.get("score_quant") and kw.get("rescore", True) else None,
          "videos": len(videos), "queries": len(queries),
          **{f"single_{k}": single[k] for k in (
              "index_s", "search_s", "queries_per_s", "peak_mem_bytes")},
          **{f"mesh_{k}": got[k] for k in (
              "index_s", "search_s", "queries_per_s", "peak_mem_bytes")},
          "mesh_vs_single_search_wall": got["search_s"] / single["search_s"],
          "same_ids": same, "scores_max_abs_err": err,
          "scores_bitwise": bool(np.array_equal(got["scores"],
                                                single["scores"])),
          "tol": tie_tol, "index_launches": got["index_launches"],
          "single_index_launches": single["index_launches"],
          "search_launches": search, "search_launches_want": want,
          "plain_queries": npl, "plain_scores_max_abs_err": plain_err,
          "plain_rows_same_ids": float(1 - flips.mean()),
          "plain_tol": TOL[("scores", "bfloat16")]})
    if not same or not err <= tie_tol:
        fail(f"{what}: ids or scores (max abs err {err}) differ from the "
             f"single-device retriever's")
    bad = {c: (search.get(c), n) for c, n in want.items()
           if search.get(c) != n}
    if bad:
        fail(f"{what}: launches per search (got, want): {bad}")
    if not plain_err <= TOL[("scores", "bfloat16")]:
        fail(f"{what}: kernel path vs plain path: max abs score error "
             f"{plain_err}")
    launches[what] = got["launches"]


def _mesh_one_branch(mesh, mesh_name, videos, queries, dev,
                     launches) -> None:
    """The one-branch twin on the mesh, exact route: the one-branch towers
    launch and each shard is scored once per batch; ids equal the
    single-device twin's."""
    import numpy as np

    from dldkd_tpu_torch.tools import workload

    twin = workload.serving_model(one_branch_of=_serving_model("bfloat16",
                                                               seed=6))
    single = _served(twin, videos, queries, dev, None, {})
    got = _served(twin, videos, queries, dev, mesh, {})
    what = f"serving exact one-branch, {mesh_name}"
    _check_launched(got["launches"], ("query_tower_1br", "context_tower_1br",
                                      "sim_max_bf16"), what)
    batches = -(-len(queries) // SERVE["query_bsz"])
    want = batches * got["live_shards"]
    emit({"phase": "serving_mesh_1br", "mesh": mesh_name,
          "search_launches": got["search_launches"],
          "scorer_launches_want": want,
          "same_ids": bool(np.array_equal(got["ids"], single["ids"])),
          "scores_max_abs_err": float(np.abs(got["scores"]
                                             - single["scores"]).max())})
    if got["search_launches"]["sim_max"] != want:
        fail(f"{what}: {got['search_launches']['sim_max']} scorer launches "
             f"per search, want {want} (one per shard and batch)")
    if not np.array_equal(got["ids"], single["ids"]):
        fail(f"{what}: ids differ from the single-device twin's")
    launches[what] = got["launches"]


def _mesh_artifacts(model, mesh, mesh_name, videos, queries, dev) -> None:
    """Index artifacts across topologies: built on `mesh`, loaded on one
    device, and built on one device, loaded on `mesh`, for the exact,
    int8-only and raw stores; the loading retriever's ids and scores
    bitwise those of the one that built the index."""
    import numpy as np

    from dldkd_tpu_torch.serving import Retriever

    bsz, k = SERVE["query_bsz"], SERVE["k"]
    qf, qm = queries.feats, queries.mask
    for name, kw in (("exact", {}),
                     ("int8_only", {"score_quant": True, "rescore": False}),
                     ("raw", {"index_store": "raw"})):
        rec = {"check": "serving_mesh_artifacts", "store": name,
               "mesh": mesh_name}
        for built_on, loaded_on in ((mesh, None), (None, mesh)):
            with tempfile.TemporaryDirectory(prefix="chip_smoke_idx_") as d:
                r = Retriever(model, query_bsz=bsz, device=dev, mesh=built_on,
                              stream_block=SERVE_MESH_BLOCK, **kw)
                r.index(videos, context_bsz=TVR["context_bsz"])
                want = r.search(qf, qm, k)
                r.save_index(os.path.join(d, "idx"))
                del r
                r = Retriever(model, query_bsz=bsz, device=dev,
                              mesh=loaded_on, stream_block=SERVE_MESH_BLOCK,
                              **kw)
                r.load_index(os.path.join(d, "idx"),
                             context_bsz=TVR["context_bsz"])
                got = r.search(qf, qm, k)
                del r
            tag = "mesh_to_single" if built_on is mesh else "single_to_mesh"
            rec[tag] = {
                "same_ids": bool(np.array_equal(got[1], want[1])),
                "scores_bitwise": bool(np.array_equal(got[0], want[0]))}
            if not all(rec[tag].values()):
                fail(f"serving artifacts {name}, {mesh_name}, {tag}: "
                     f"{rec[tag]}")
        emit(rec)


def phase_serving_mesh(dev, videos, queries) -> dict:
    """Corpus-sharded serving at TVR scale (`Retriever(mesh=...)`, bf16
    serving model, query batch 256, k 10) on a mesh of two shards on `dev`
    and on `make_mesh()` (every GPU; a mesh of one on one GPU), each route
    against the single-device Retriever on the same route, run in turns;
    the one-branch twin; index artifacts across topologies. Returns each
    path's launch counts."""
    import torch

    from dldkd_tpu_torch.parallel import make_mesh

    t0 = time.perf_counter()
    model = _serving_model("bfloat16", seed=6)
    meshes = ((make_mesh(devices=[dev] * 2), f"2 shards on {dev}"),
              (make_mesh(), f"{torch.cuda.device_count()} GPUs"))
    launches = {}
    saved_mode = os.environ.get("DLDKD_DENSE_RESCORE")
    try:
        for name, kw, mode, kernels, scorers in SERVE_MESH_ROUTES:
            _pin_dense_rescore(mode)
            single = _served(model, videos, queries, dev, None, kw)
            for mesh, mesh_name in meshes:
                _mesh_route(model, name, kw, mode, kernels, scorers, mesh,
                            mesh_name, single, videos, queries, dev,
                            launches)
            del single
    finally:
        _pin_dense_rescore(saved_mode)
    for mesh, mesh_name in meshes:
        _mesh_one_branch(mesh, mesh_name, videos, queries, dev, launches)
        _mesh_artifacts(model, mesh, mesh_name, videos, queries, dev)
    del model
    torch.cuda.empty_cache()
    emit({"phase": "serving_mesh", "seconds": time.perf_counter() - t0})
    return launches


# -------------------------------------------------- slice 12: the benches

# the kernels each in-process bench path must launch: stage_bench's
# one-branch rows reach the one-branch towers (Pallas `fused_query_tower`,
# `fused_context_tower`); the port bench's eval, train and streaming parts
STAGE_KERNELS = ("query_tower_bf16", "context_tower_bf16", "query_tower_1br",
                 "context_tower_1br", "sim_max_bf16", "sim_max_int8",
                 "context_tower_q8")
PORT_BENCH_KERNELS = ("query_tower_bf16", "context_tower_bf16",
                      "sim_max_bf16", "sim_max_int8", "context_tower_q8")
# repetitions in this check's runs (the tools' defaults otherwise): the
# stage bench's per stage, stream_bench's passes (the port bench's
# streaming_8x times the same pass at 4); the C5 check's queries
BENCHES = dict(stage_reps=3, stream_reps=1, flip_queries=1024)


def _tool(name: str, args, timeout: int = 900) -> tuple:
    """`python -m dldkd_tpu_torch.tools.<name> args` in a fresh process
    from the repository root: its last stdout line (JSON) and seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"dldkd_tpu_torch.tools.{name}", *args],
        capture_output=True, text=True, timeout=timeout,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    secs = time.perf_counter() - t0
    if proc.returncode:
        fail(f"{name} {args}: exit {proc.returncode}: {proc.stderr[-1500:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1]), secs


def _check_times(values, what: str) -> None:
    bad = [v for v in values
           if not (isinstance(v, (int, float)) and math.isfinite(v)
                   and v > 0)]
    if bad:
        fail(f"{what}: times not finite and positive: {bad}")


def _bench_shape_checks(dev) -> dict:
    """The kernels of the benches' paths at the shapes stage_bench and the
    port bench give them, on their own inputs and weights
    (`workload.serving_inputs` and `serving_model`, seed 0): 11,264
    queries in one query-tower launch, 2,304 videos in one video-tower
    launch. The towers of the two-branch model and of its one-branch twin
    against their plain versions (`_tower_check`, TOL tower bf16). Then
    the int8 route, stage by stage, each stage held exactly: the int8
    epilogue of the kernel's towers against its plain version on the same
    frames (bitwise), and the int8 scorer of all the queries on an index
    and query vectors built once on the plain path, kernel against plain
    (every valid video's score bitwise). Last, C5 on the whole route: the
    first BENCHES["flip_queries"] queries' ranks, kernel path against
    plain path, every rank that differs a near tie (crossing gap within
    twice TOL scores bf16). Returns each record by name."""
    import torch
    import torch.nn.functional as F

    from dldkd_tpu_torch.ops.fast_eval import (encode_context_best,
                                               encode_context_q8,
                                               encode_query_best,
                                               tower_weights)
    from dldkd_tpu_torch.ops.kernels import query_tower as qt
    from dldkd_tpu_torch.ops.kernels import sim_max
    from dldkd_tpu_torch.ops.masking import l2_normalize
    from dldkd_tpu_torch.ops.similarity import clip_scores_maxpool_pre8
    from dldkd_tpu_torch.tools import workload as wl

    data = wl.serving_inputs(dev, wl.N_VIDEOS, wl.N_QUERIES)
    frames = data.pop("vfeats").float()   # the benches widen it so
    vmask, qfeats, qmask, gt = (data[k] for k in ("vmask", "qfeats",
                                                  "qmask", "gt"))
    dual = wl.serving_model(0, dev)
    one = wl.serving_model(device=dev, one_branch_of=dual)
    heads, bf, lq, lf = TVR["heads"], torch.bfloat16, qfeats.shape[1], \
        frames.shape[1]
    out = {}

    def outs(fn):
        return lambda: [t for t in fn() if t is not None]

    for model, tag in ((dual, "dual"), (one, "1br")):
        ws = tower_weights(model, dev)
        branches = len(model.branches)
        # query_towers' token mask: positions past the table are padding
        n_pos = min(w[2].shape[0] for w in ws["query"])
        mq = F.pad(qmask[:, :n_pos], (0, lq - n_pos))
        pq, pc = ws["packed"]["query"][0], ws["packed"]["context"][0]
        out[f"query_tower_{tag}"] = _tower_check(
            "query", "bfloat16", branches, tuple(qfeats.shape), lq, pq,
            outs(lambda: encode_query_best(model, qfeats, qmask, ws)),
            outs(lambda: encode_query_best(model, qfeats, qmask, ws,
                                           plain=True)),
            lambda: qt.tower_cuda(qfeats, mq, pq, heads, bf, "query",
                                  pos_rows=lq),
            n_plain=5, shapes_of="stage_bench, port bench")
        out[f"context_tower_{tag}"] = _tower_check(
            "context", "bfloat16", branches, tuple(frames.shape), lf, pc,
            outs(lambda: encode_context_best(model, frames, vmask, ws)),
            outs(lambda: encode_context_best(model, frames, vmask, ws,
                                             plain=True)),
            lambda: qt.tower_cuda(frames, vmask, pc, heads, bf, "context",
                                  pos_rows=lf),
            n_plain=5, shapes_of="stage_bench, port bench")
    del one
    torch.cuda.empty_cache()

    # the int8 route: the epilogue on the kernel's own frames
    ws = tower_weights(dual, dev)
    k8 = encode_context_q8(dual, frames, vmask, ws)
    kf = encode_context_best(dual, frames, vmask, ws)
    p8 = encode_context_q8(dual, frames, vmask, ws, plain=True)
    torch.cuda.synchronize()
    epi = {"check": "bench_context_tower_q8", "dtype": "bfloat16",
           "shape": {"frames": [2, *kf[0].shape]},
           "max_abs_err": max(max_err(a, qt.quantize_frames_q8_plain(f))
                              for a, f in zip(k8, kf)),
           "tol": TOL[("context_tower_q8", "bfloat16")],
           "vs_plain_towers_max_levels": max(
               int((a.int() - b.int()).abs().max()) for a, b in zip(k8, p8)),
           "vs_plain_towers_share_off": sum(
               int((a != b).sum()) for a, b in zip(k8, p8))
           / (2 * k8[0].numel())}
    del kf
    emit(epi)
    out["context_tower_q8"] = epi
    if not epi["max_abs_err"] <= epi["tol"] \
            or epi["vs_plain_towers_max_levels"] > 1:
        fail(f"bench int8 epilogue: {epi}")

    # the scorer, every query, on the plain path's index and queries
    k_idx = [sim_max.build_q8_index(t, vmask) for t in k8]
    p_idx = [sim_max.build_q8_index(t, vmask) for t in p8]
    del k8, p8
    kq = encode_query_best(dual, qfeats, qmask, ws)
    pq = encode_query_best(dual, qfeats, qmask, ws, plain=True)
    nv, (nq, h), nv_pad = wl.N_VIDEOS, pq[0].shape, frames.shape[0]
    del frames
    got = [clip_scores_maxpool_pre8(q, *i) for q, i in zip(pq, p_idx)]
    want = [clip_scores_maxpool_pre8(q, *i, plain=True)
            for q, i in zip(pq, p_idx)]
    torch.cuda.synchronize()
    q8 = sim_max.quantize_unit_int8(l2_normalize(pq[0])).contiguous()
    c8, bias = p_idx[0]
    n_bytes = nq * h + nv_pad * lf * h + nv_pad * lf * 4 + nq * nv_pad * 4
    b_ms, b_by = bound(n_bytes, 2 * nq * nv_pad * lf * h, "int8")
    sc = {"check": "bench_sim_max_int8", "dtype": "int8",
          "shape": {"q": [nq, h], "ctx": [nv_pad, lf, h]},
          "max_abs_err": max(max_err(g[:, :nv], w[:, :nv])
                             for g, w in zip(got, want)),
          "tol": TOL[("sim_max_int8", "int8")],
          "bitwise_valid_columns": all(
              bool(torch.equal(g[:, :nv], w[:, :nv]))
              for g, w in zip(got, want)),
          "kernel_ms": cuda_ms(scoring_launch("sim_max_int8", q8, c8, bias)),
          "wrapper_ms": cuda_ms(lambda: clip_scores_maxpool_pre8(
              pq[0], c8, bias)),
          "plain_ms": cuda_ms(lambda: clip_scores_maxpool_pre8(
              pq[0], c8, bias, plain=True), n=5),
          "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
          "shapes_of": "stage_bench pre8 row, port bench int8 route"}
    del got, q8
    emit(sc)
    out["sim_max_int8"] = sc
    if not sc["bitwise_valid_columns"]:
        fail(f"bench int8 scorer: valid columns differ from the plain "
             f"version by {sc['max_abs_err']}")

    # C5 on the whole route: kernel path against plain path
    n = BENCHES["flip_queries"]
    k_i, k_e = (clip_scores_maxpool_pre8(q[:n], *i)[:, :nv]
                for q, i in zip(kq, k_idx))
    p_i, p_e = (w[:n, :nv] for w in want)
    tol = TOL[("scores", "bfloat16")]
    flips = _rank_flip_list(k_i, k_e, p_i, p_e, gt[:n])
    rec = {"check": "bench_int8_kernel_vs_plain", "queries": n,
           "videos": nv,
           "scores_max_abs_err": max(max_err(k_i, p_i), max_err(k_e, p_e)),
           "tol": tol, "near_tie_tol": 2 * tol, "rank_flips": len(flips),
           "max_crossing_gap": max((f["gap"] for f in flips), default=0.0),
           "flips": flips[:20]}
    emit(rec)
    out["int8_flips"] = rec
    if rec["scores_max_abs_err"] > tol \
            or any(f["gap"] > 2 * tol for f in flips):
        fail(f"bench int8 eval: kernel vs plain scores differ by "
             f"{rec['scores_max_abs_err']}, flips {flips[:5]}")
    del data, dual, ws, k_idx, p_idx, kq, pq, want, k_i, k_e, p_i, p_e
    torch.cuda.empty_cache()
    return out


def _search_ids_check(dev, ids_path: str) -> dict:
    """search_bench's exact row on its first batch against
    `Retriever.search` on the same batch (the same seeded corpus, weights
    and queries, the index built in one tower launch as the tool builds
    it): the ids must be equal."""
    import numpy as np
    import torch

    from dldkd_tpu_torch.data.ingest import PackedVideos
    from dldkd_tpu_torch.serving import Retriever
    from dldkd_tpu_torch.tools import search_bench
    from dldkd_tpu_torch.tools import workload as wl

    data = search_bench.search_inputs(dev, wl.N_VIDEOS, 1, 256)
    n_pad = data["vfeats"].shape[0]
    videos = PackedVideos(feats=data["vfeats"].float().cpu().numpy(),
                          mask=data["vmask"].cpu().numpy(),
                          ids=[f"v{i}" for i in range(n_pad)])
    r = Retriever(wl.serving_model(0, dev), query_bsz=256, device=dev)
    r.index(videos, context_bsz=n_pad)
    _, got = r.search(data["qfeats"][0].cpu().numpy(),
                      data["qmask"][0].cpu().numpy(), k=search_bench.K)
    want = np.load(ids_path)
    rec = {"check": "search_bench_exact_ids_vs_retriever",
           "shape": list(want.shape), "equal": bool(np.array_equal(got,
                                                                    want))}
    emit(rec)
    if not rec["equal"]:
        fail(f"search_bench exact ids differ from Retriever.search's: "
             f"{int((got != want).sum())} of {want.size}")
    del r, videos, data
    torch.cuda.empty_cache()
    return rec


def phase_benches(dev, card: str) -> tuple:
    """The port's benches on the card (`dldkd_tpu_torch/tools/`). In this
    process, with the launch counts set to 0 just before each and read
    just after: stage_bench (3 reps a stage) and the port bench's whole
    line (`tools/bench.main`: the eval keys at TVR scale, the train keys,
    the fleet drill of coldstart_bench --policy fleet --replicas 2
    --n_videos 545 in subprocesses, streaming at 8x TVR); each must launch
    every kernel of its path, stage_bench the one-branch towers too, run
    no plain version, and give finite positive times; the port bench's
    line must carry bench.py's keys, vs_baseline null, train_speed null
    with its reason, the card's name and power limit as `device`, both
    fleet replicas. Between the two, `_bench_shape_checks`: every kernel
    of these paths against its plain version at the shapes they give it,
    and C5 on the bench's int8 eval. In fresh processes: search_bench (its
    exact row's first-batch ids against Retriever.search's), stream_bench
    --scale 8 --reps 1 --host, and coldstart_bench --policy cold (a fresh
    kernel-library directory: the nvcc builds are in its time). HOME
    points at a temporary directory for the phase, so the drill's artifact
    and library directory live and die with it; that library directory is
    filled from this run's build. Returns each in-process path's launch
    counts and the records of `_bench_shape_checks`."""
    import shutil

    import torch

    from dldkd_tpu_torch.ops.kernels import build
    from dldkd_tpu_torch.tools import bench, stage_bench

    t_phase = time.perf_counter()
    launches = {}
    _reset_counts()
    with _PlainCalls() as plain:
        t0 = time.perf_counter()
        rec = stage_bench.main(["--reps", str(BENCHES["stage_reps"])])
        secs = time.perf_counter() - t0
    launches["stage_bench"] = counts = _counts()
    emit({"phase": "stage_bench", "card": card, "seconds": secs,
          "launches": counts, "plain_calls": plain.calls, **rec})
    _check_launched(counts, STAGE_KERNELS, "stage_bench")
    if plain.calls:
        fail(f"stage_bench: plain versions ran: {plain.calls}")
    _check_times(list(rec["stages_ms"].values())
                 + [rec["sum_ms"], rec["q8_sum_ms"]], "stage_bench")
    torch.cuda.empty_cache()
    checks = _bench_shape_checks(dev)

    saved_home = os.environ.get("HOME")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_home_") as home:
        kernel_dir = os.path.join(home, ".cache", "dldkd_torch_kernels")
        os.makedirs(kernel_dir)
        for path in build.build().values():
            shutil.copy2(path, kernel_dir)
        os.environ["HOME"] = home
        try:
            _reset_counts()
            with _PlainCalls() as plain:
                t0 = time.perf_counter()
                line = bench.main([])
                secs = time.perf_counter() - t0
            launches["bench"] = counts = _counts()
            emit({"phase": "port_bench", "card": card, "seconds": secs,
                  "launches": counts, "plain_calls": plain.calls})
            _check_launched(counts, PORT_BENCH_KERNELS, "port bench")
            if plain.calls:
                fail(f"port bench: plain versions ran: {plain.calls}")
            missing = [k for k in bench.BENCH_KEYS if k not in line]
            fleet = line.get("coldstart_fleet", {})
            if missing or line["vs_baseline"] is not None \
                    or line["train_speed"]["value"] is not None \
                    or not line["train_speed"].get("reason") \
                    or line["device"] != card \
                    or len(fleet.get("first_result_s", [])) != 2:
                fail(f"port bench line: missing {missing} or wrong values: "
                     f"{json.dumps(line)[:800]}")
            _check_times([line["value"], line["exact_bf16"]["value"],
                          line["train"]["value"], line["train_bf16"]["value"],
                          line["train_bf16_stacked"]["value"],
                          line["train_scan"]["f32_parity"],
                          line["train_scan"]["speed_stack"],
                          fleet["p50_first_result_s"],
                          fleet["p95_first_result_s"],
                          fleet["max_first_search_s"],
                          line["streaming_8x"]["value"]], "port bench")
            torch.cuda.empty_cache()

            with tempfile.TemporaryDirectory(prefix="chip_smoke_ids_") as d:
                ids_path = os.path.join(d, "exact_ids.npy")
                search, secs = _tool("search_bench", ["--ids_out", ids_path])
                emit({"phase": "search_bench", "card": card, "seconds": secs,
                      "ms_per_batch": search})
                if list(search) != ["exact", "two_stage", "two_stage_q8",
                                    "int8_only_q8"]:
                    fail(f"search_bench rows: {search}")
                _check_times(search.values(), "search_bench")
                ids = _search_ids_check(dev, ids_path)

            stream, secs = _tool("stream_bench", [
                "--scale", "8", "--reps", str(BENCHES["stream_reps"]),
                "--host"])
            emit({"phase": "stream_bench", "card": card, "seconds": secs,
                  **stream})
            if stream["detail"]["videos"] != 8 * TVR["n_videos"] \
                    or "host_stream" not in stream:
                fail(f"stream_bench: {stream}")
            _check_times([stream["value"], stream["detail"]["qps"],
                          stream["host_stream"]["seconds"]], "stream_bench")

            cold, secs = _tool("coldstart_bench", ["--policy", "cold"])
            emit({"phase": "coldstart_bench", "card": card, "seconds": secs,
                  **cold})
            _check_times([cold["first_result_s"], cold["index_s"],
                          cold["first_search_s"]], "coldstart_bench cold")
            if not cold["first_result_s"] > cold["first_search_s"]:
                fail(f"coldstart_bench cold: {cold}")
        finally:
            if saved_home is None:
                os.environ.pop("HOME", None)
            else:
                os.environ["HOME"] = saved_home
    emit({"phase": "benches", "seconds": time.perf_counter() - t_phase,
          "port_bench_line": line,
          "bench_int8_flips": checks["int8_flips"]["rank_flips"],
          "search_ids_equal": ids["equal"]})
    return launches, checks


# ------------------------------------------------- slice 7: training

# the train phase's dataset: do_tvr.sh's widths (video 1024, query 768,
# teacher 512 as dldkd_tpu/tools/train_bench.py:107), 128 frames, 30 tokens;
# noise 6 (the generator's default is 0.6) keeps val SumR rising over the
# epochs (on the CPU: 23 untrained, then 306, 378, 386), where the default
# noise saturates it at 400 after one epoch
TRAIN = dict(n_train=1024, n_val=500, n_test=500, d_video=1024, d_query=768,
             d_teacher=512, frames=128, tokens=30, noise=6.0, bsz=128,
             timed_steps=10, profiled_steps=5)
# scripts/do_tvr.sh's hyperparameters, and the dataset's layout
TRAIN_ARGS = ["--collection", "synthetic", "--visual_feature", "i3d",
              "--dset_name", "synthetic", "--q_feat_size", "768",
              "--model_name", "DLDKD", "--margin", "0.1", "--exp_id", "smoke",
              "--n_heads", "4", "--distill_loss_decay", "exp",
              "--double_branch", "--drop", "0.2", "--input_drop", "0.2",
              "--lr", "0.0003", "--label_style", "soft",
              "--inheritance_hidden", "384", "--exploration_hidden", "384",
              "--max_ctx_l", "128", "--max_desc_l", "30", "--bsz", "128",
              "--torch_device", "cuda"]
TRAIN_KERNELS = _eval_kernels("float32")
# the bf16 + stacked run's validation: bf16 scoring, both bf16 towers
TRAIN_KERNELS_BF16 = _eval_kernels("bfloat16")
# the train bench's settings (dtype, stacked, matmul precision: None is
# the bench's per-dtype default; the last is the trainer's own bf16
# default) and repetitions per stage
TRAIN_BENCH = dict(settings=(("float32", False, None), ("float32", True, None),
                             ("bfloat16", False, None),
                             ("bfloat16", True, None),
                             ("bfloat16", True, "highest")),
                   reps=8)


class _PlainCalls:
    """Counts calls of the scorers' and towers' plain versions while
    active (the eval path on the card must make none)."""

    def __enter__(self):
        from dldkd_tpu_torch.ops import similarity
        from dldkd_tpu_torch.ops.kernels import query_tower, sim_max

        self.calls = {}
        self._saved = []
        for mod, name in ((query_tower, "tower_plain"),
                          (sim_max, "sim_max_plain"),
                          (similarity, "sim_max_plain")):
            real = getattr(mod, name)

            def counted(*a, _real=real, _name=name, **kw):
                self.calls[_name] = self.calls.get(_name, 0) + 1
                return _real(*a, **kw)

            self._saved.append((mod, name, real))
            setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, real in self._saved:
            setattr(mod, name, real)


def _run_dir(results_root: str) -> str:
    import glob

    dirs = glob.glob(os.path.join(results_root, "*", "*-*"))
    if len(dirs) != 1:
        fail(f"train: expected one run directory under {results_root}, "
             f"found {dirs}")
    return dirs[0]


def _train_history(run_dir: str):
    """(per-step loss records, per-eval fused SumR, epochs in
    train.log.txt) of a run."""
    with open(os.path.join(run_dir, "tensorboard_log", "metrics.jsonl")) as f:
        recs = [json.loads(x) for x in f]
    steps = [r for r in recs if "Train/loss_overall" in r]
    sumrs = [r["Val/fused_sumr"] for r in recs if "Val/fused_sumr" in r]
    with open(os.path.join(run_dir, "train.log.txt")) as f:
        epochs = [int(line.split("[Epoch] ")[1].split()[0])
                  for line in f if "[Epoch]" in line]
    return steps, sumrs, epochs


def _check_losses(steps, what: str) -> None:
    from dldkd_tpu_torch.train import LOSS_KEYS

    bad = [r for r in steps
           if not all(math.isfinite(r[f"Train/{k}"]) for k in LOSS_KEYS)]
    if not steps or bad:
        fail(f"{what}: {len(steps)} steps logged, non-finite losses in "
             f"{bad[:2]}")


def _op_class(name: str) -> str:
    """A train-step kernel's class, by its name."""
    low = name.lower()
    for key, cls in (("memcpy", "copies"), ("memset", "copies"),
                     ("gemm", "products"), ("xmma", "products"),
                     ("cutlass", "products"), ("gemv", "products"),
                     ("softmax", "softmax"), ("layer_norm", "layernorm"),
                     ("sort", "sort"), ("reduce", "reductions"),
                     ("index", "gather_scatter"), ("gather", "gather_scatter"),
                     ("scatter", "gather_scatter"),
                     ("elementwise", "elementwise"), ("cat", "elementwise"),
                     ("fill", "elementwise"), ("copy", "elementwise")):
        if key in low:
            return cls
    return "other"


TRAIN_STEP_PARTS = ("train_step/forward_losses", "train_step/backward",
                    "train_step/optimizer")


def _trace_breakdown(path: str) -> dict:
    """Device time by op class, by kernel and by part of the step, and the
    device's idle share, over a chrome trace written by torch.profiler
    (train.py's --profile_dir). A kernel or copy belongs to the part
    (train_step's profiler ranges) whose host range holds its launch."""
    from dldkd_tpu_torch.tools.train_bench import span_union

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    parts = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("cat") == "user_annotation"
             and e.get("name") in TRAIN_STEP_PARTS]
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") == "cuda_runtime"
                and "correlation" in e.get("args", {})}
    spans, by_class, by_kernel, by_part = [], {}, {}, {}
    t_lo, t_hi = None, None
    for e in events:
        if "ts" not in e or "dur" not in e:
            continue
        ts, dur = float(e["ts"]), float(e["dur"])
        t_lo = ts if t_lo is None else min(t_lo, ts)
        t_hi = ts + dur if t_hi is None else max(t_hi, ts + dur)
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        spans.append((ts, ts + dur))
        cls = _op_class(e.get("name", ""))
        by_class[cls] = by_class.get(cls, 0.0) + dur
        key = _short_kernel_name(e.get("name", ""))
        t, c = by_kernel.get(key, (0.0, 0))
        by_kernel[key] = (t + dur, c + 1)
        at = launched.get(e.get("args", {}).get("correlation"))
        part = next((name for a, b, name in parts
                     if at is not None and a <= at <= b), "outside the step")
        by_part[part] = by_part.get(part, 0.0) + dur
    busy = span_union(spans)
    wall = (t_hi - t_lo) if spans else 0.0
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    return {"trace_wall_ms": wall / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": (1.0 - busy / wall) if wall else None,
            "device_events": len(spans),
            "device_ms_by_part": {k: v / 1e3 for k, v in by_part.items()},
            "device_ms_by_class": {k: v / 1e3 for k, v in sorted(
                by_class.items(), key=lambda kv: -kv[1])},
            "top_kernels": {k: {"ms": t / 1e3, "count": c}
                            for k, (t, c) in top}}


def _step_times(model, mcfg, cfg, batches, dev):
    """train_step on the card, synchronized after each: per-step wall ms
    and peak memory."""
    import statistics

    import torch

    from dldkd_tpu_torch import train
    from dldkd_tpu_torch.optim import BertAdam, default_wd_mask

    named = dict(model.named_parameters())
    opt = BertAdam(named, cfg.train.lr, None, weight_decay=cfg.train.wd,
                   wd_mask=default_wd_mask(named))
    gen = torch.Generator(device=dev).manual_seed(1)
    scalars = train.epoch_scalars(cfg, 2, dev)
    wall = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN["timed_steps"] + 1):
        t0 = time.perf_counter()
        train.train_step(model, mcfg, cfg.train, opt,
                         batches[i % len(batches)], gen, scalars)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(wall[1:])
    return {"first_step_ms": wall[0], "step_ms_median": med,
            "step_ms_all": wall[1:],
            "samples_per_s": TRAIN["bsz"] / med * 1e3,
            "peak_mem_bytes": torch.cuda.max_memory_allocated()}


class _ReluBranches:
    """Forward hooks on a model's ReLUs. Without `replay`, records each
    call's sign pattern (input > 0) and input; with `replay` (an earlier
    record's patterns), each ReLU follows that pattern instead, as
    input * pattern, and its gradient follows it too."""

    def __init__(self, model, replay=None):
        import torch

        self.masks, self.inputs, self._replay = [], [], replay
        self._hooks = [m.register_forward_hook(self._hook)
                       for m in model.modules()
                       if isinstance(m, torch.nn.ReLU)]

    def _hook(self, module, inp, out):
        x = inp[0]
        if self._replay is None:
            self.masks.append((x > 0).cpu())
            self.inputs.append(x.detach().double().cpu())
            return None
        mask = self._replay[len(self.masks)]
        self.masks.append(mask)
        return x * mask.to(x.device, x.dtype)

    def close(self):
        for h in self._hooks:
            h.remove()


def _cpu_step_check(state_dict, mcfg, cfg, batch_np, dev):
    """One train step on the card against the same step on the CPU, from
    the same state and batch, dropout 0, hard negatives from a pool of 1.

    The step's gradient is discontinuous where a ReLU's input is 0: an
    input within rounding of 0 passes its gradient on one device and not
    on the other, and BertAdam's first step turns the gradient entries
    that this moves (near 0 after its per-tensor clip) into updates of up
    to ~3 lr. So the CPU float32 step is not the reference for the
    parameters: both float32 steps are compared with the CPU float64 step,
    their ReLU sign flips against it are counted with the float64 inputs
    where they flip, and the card is held against the float64 step taken
    on the card's ReLU signs. Held: the losses within 1e-4 of the CPU
    float32 step's; every parameter within 1e-5 and the gradient within
    1e-4 of its norm of the float64 step on the card's signs; each flip
    at a float64 input within 1e-5 of 0."""
    import torch

    from dldkd_tpu_torch import train
    from dldkd_tpu_torch.models import DLDKD
    from dldkd_tpu_torch.optim import BertAdam, default_wd_mask

    run_cfg = mcfg.replace(input_drop=0.0, drop=0.0, use_hard_negative=True,
                           hard_pool_size=1)

    def step(where, dtype, replay=None):
        model = DLDKD(run_cfg)
        model.load_state_dict(state_dict)
        model.to(where, dtype)
        named = dict(model.named_parameters())
        opt = BertAdam(named, cfg.train.lr, None, weight_decay=cfg.train.wd,
                       wd_mask=default_wd_mask(named))
        grads = {}
        real_step = opt.step

        def opt_step(gs, _real=real_step, _names=list(named)):
            grads.update({n: g.detach().double().cpu()
                          for n, g in zip(_names, gs)})
            return _real(gs)

        opt.step = opt_step
        batch = {k: torch.from_numpy(v).to(where) for k, v in batch_np.items()}
        batch = {k: v.to(dtype) if v.is_floating_point() else v
                 for k, v in batch.items()}
        branches = _ReluBranches(model, replay)
        try:
            losses = train.train_step(
                model, run_cfg, cfg.train, opt, batch,
                torch.Generator(device=where),
                train.epoch_scalars(cfg, 0, where))
        finally:
            branches.close()
        return {"losses": {k: float(v) for k, v in losses.items()},
                "grads": grads, "branches": branches,
                "params": {k: v.detach().double().cpu()
                           for k, v in model.state_dict().items()}}

    f64 = step("cpu", torch.float64)
    cpu = step("cpu", torch.float32)
    card = step(dev, torch.float32)
    f64_card_signs = step("cpu", torch.float64, replay=card["branches"].masks)

    def apart(a, b):
        ga, gb = a["grads"], b["grads"]
        g_err = math.sqrt(sum(float((ga[k] - gb[k]).norm()) ** 2
                              for k in gb))
        g_norm = math.sqrt(sum(float(gb[k].norm()) ** 2 for k in gb))
        diffs = torch.cat([(a["params"][k] - b["params"][k]).abs().flatten()
                           for k in b["params"]])
        worst = max(b["params"], key=lambda k: float(
            (a["params"][k] - b["params"][k]).abs().max()))
        i = int((a["params"][worst] - b["params"][worst]).abs().argmax())
        return {"loss_max_abs_err": max(abs(a["losses"][k] - b["losses"][k])
                                        for k in b["losses"]),
                "grad_norm_rel_err": g_err / g_norm,
                "param_max_abs_err": float(diffs.max()),
                "params_over_1e-5": int((diffs > 1e-5).sum()),
                "worst_entry": {"name": worst, "index": i,
                                "grad": float(ga[worst].flatten()[i]),
                                "grad_ref": float(gb[worst].flatten()[i])}}

    def flips(a):
        ref = f64["branches"]
        n, at = 0, 0.0
        for ma, mr, x in zip(a["branches"].masks, ref.masks, ref.inputs):
            d = ma != mr
            n += int(d.sum())
            if d.any():
                at = max(at, float(x[d].abs().max()))
        return {"relu_sign_flips": n, "flip_max_abs_input_f64": at}

    out = {"card_vs_cpu": apart(card, cpu),
           "cpu_vs_f64": {**apart(cpu, f64), **flips(cpu)},
           "card_vs_f64": {**apart(card, f64), **flips(card)},
           "card_vs_f64_on_card_signs": apart(card, f64_card_signs),
           "relu_inputs": sum(m.numel() for m in f64["branches"].masks),
           "loss_tol": 1e-4, "grad_tol": 1e-4, "param_tol": 1e-5,
           "flip_input_tol": 1e-5,
           "losses_card": card["losses"], "losses_cpu": cpu["losses"]}
    same = out["card_vs_f64_on_card_signs"]
    out["ok"] = (out["card_vs_cpu"]["loss_max_abs_err"] <= 1e-4
                 and same["param_max_abs_err"] <= 1e-5
                 and same["grad_norm_rel_err"] <= 1e-4
                 and out["card_vs_f64"]["flip_max_abs_input_f64"] <= 1e-5)
    return out


def _rank_flip_list(k_i, k_e, p_i, p_e, gt) -> list:
    """Each query whose ground-truth rank under the fused scores differs
    between the kernel path (k) and the plain path (p): both ranks and the
    widest plain-path gap between the ground truth and a video that
    crossed it (a near tie is a crossing within the scores' tolerance)."""
    kf, pf = 0.7 * k_i + 0.3 * k_e, 0.7 * p_i + 0.3 * p_e
    r_k, r_p = _rank_rows(k_i, k_e, gt), _rank_rows(p_i, p_e, gt)
    flips = []
    for q in (r_k != r_p).nonzero()[:, 0].tolist():
        g = int(gt[q])
        crossed = (kf[q] > kf[q, g]) != (pf[q] > pf[q, g])
        gap = float((pf[q] - pf[q, g]).abs()[crossed].max()) \
            if crossed.any() else 0.0
        flips.append({"query": q, "rank_kernel": int(r_k[q]),
                      "rank_plain": int(r_p[q]), "gap": gap})
    return flips


def _near_tie_flips(k_i, k_e, p_i, p_e, gt) -> dict:
    """How many ground-truth ranks differ between the kernel path and the
    plain path, and the widest crossing gap among them."""
    flips = _rank_flip_list(k_i, k_e, p_i, p_e, gt)
    return {"rank_flips": len(flips),
            "max_crossing_gap": max((f["gap"] for f in flips), default=0.0),
            "queries": int(k_i.shape[0]),
            "near_tie_tol": 2 * TOL[("scores", "bfloat16")]}


def _int8_checkpoint_flips(model, videos, queries, eval_cfg, dev,
                           what: str) -> dict:
    """ROADMAP C5 row by row: the int8 eval (score_quant) of a trained
    checkpoint, kernel path against plain path on the card: the scores'
    largest difference, fused SumR of each, and every rank flip of the
    ground truth with its plain-path gap. Fails unless the scores agree
    within the int8 eval's tolerance and every flip is a near tie."""
    import torch

    from dldkd_tpu_torch.evaluate import (_metrics_from_score_matrices,
                                          score_matrices)
    from dldkd_tpu_torch.metrics import build_gt_indices

    args = (model, videos, queries, eval_cfg.eval_context_bsz,
            eval_cfg.eval_query_bsz, dev)
    _reset_counts()
    k = score_matrices(*args, score_quant=True)
    counts = _counts()
    p = score_matrices(*args, plain=True, score_quant=True)
    n = len(videos)
    k_i, k_e, p_i, p_e = (s[:, :n] for s in k + p)
    gt = torch.from_numpy(build_gt_indices(queries.video_ids,
                                           videos.ids)).to(dev)
    tol = TOL[("scores", "bfloat16")]
    flips = _rank_flip_list(k_i, k_e, p_i, p_e, gt)
    rec = {"check": "int8_trained_checkpoint", "what": what,
           "queries": len(queries), "videos": n,
           "scores_max_abs_err": max(max_err(k_i, p_i), max_err(k_e, p_e)),
           "tol": tol, "near_tie_tol": 2 * tol,
           "kernel_path_fused_sumr": _metrics_from_score_matrices(
               k_i, k_e, gt, (0.7, 0.3))["fused"]["sumr"],
           "plain_path_fused_sumr": _metrics_from_score_matrices(
               p_i, p_e, gt, (0.7, 0.3))["fused"]["sumr"],
           "rank_flips": len(flips), "flips": flips, "launches": counts}
    emit(rec)
    _check_launched(counts, INT8_EVAL_KERNELS, what)
    if rec["scores_max_abs_err"] > tol \
            or any(f["gap"] > 2 * tol for f in flips):
        fail(f"{what}: int8 kernel vs plain scores differ by "
             f"{rec['scores_max_abs_err']}, flips {flips[:5]}")
    return rec


def _stacked_vs_sequential(state_dict, mcfg, batch_np, dev) -> dict:
    """The stacked forward against the sequential one on the card, eval
    mode (dropout off), from the same weights and batch, in f32 and bf16:
    the largest difference over the four tower outputs."""
    import torch

    from dldkd_tpu_torch.models import DLDKD
    from dldkd_tpu_torch.models.stacked import encode_stacked

    out = {}
    args = tuple(torch.from_numpy(batch_np[k]).to(dev) for k in (
        "student_videos", "student_videos_mask", "student_text",
        "student_text_mask"))
    for dtype in ("float32", "bfloat16"):
        model = DLDKD(mcfg.replace(dtype=dtype))
        model.load_state_dict(state_dict)
        model.to(dev).eval()
        with torch.no_grad():
            seq = model(*args)
            st = encode_stacked(model, *args)
        out[dtype] = max(max_err(a, b) for a, b in zip(seq[0] + seq[1],
                                                       st[0] + st[1]))
    return out


def _bf16_step_vs_cpu(state_dict, mcfg, cfg, batch_np, dev) -> dict:
    """One bf16 stacked train step on the card and on the CPU from the
    same state and batch, dropout 0, hard negatives from a pool of 1: the
    losses of each and the parameters after the step. Held: loss_overall
    within rtol 1e-2; the card's update (parameters after minus before,
    so the backward and BertAdam) apart from the CPU's by less than the
    CPU update's norm (an uncorrelated update of the same size is sqrt(2)
    apart, a negated one 2; BertAdam's first step moves each entry by up
    to ~3 lr with its gradient's sign, so a gradient entry near 0 whose
    sign differs between the devices moves that parameter apart by up to
    twice that: such flips alone stay well inside the bound), and no
    parameter apart by more than twice the largest update entry."""
    import dataclasses

    import torch

    from dldkd_tpu_torch import train
    from dldkd_tpu_torch.models import DLDKD
    from dldkd_tpu_torch.optim import BertAdam, default_wd_mask

    run_cfg = mcfg.replace(dtype="bfloat16", input_drop=0.0, drop=0.0,
                           use_hard_negative=True, hard_pool_size=1)
    tcfg = dataclasses.replace(cfg.train, stacked_towers=True)
    losses, updates = {}, {}
    for side, where in (("cpu", torch.device("cpu")), ("card", dev)):
        model = DLDKD(run_cfg)
        model.load_state_dict(state_dict)
        model.to(where)
        named = dict(model.named_parameters())
        opt = BertAdam(named, cfg.train.lr, None, weight_decay=cfg.train.wd,
                       wd_mask=default_wd_mask(named))
        batch = {k: torch.from_numpy(v).to(where)
                 for k, v in batch_np.items()}
        ld = train.train_step(model, run_cfg, tcfg, opt, batch,
                              torch.Generator(device=where),
                              train.epoch_scalars(cfg, 0, where))
        losses[side] = {k: float(v) for k, v in ld.items()}
        updates[side] = torch.cat([
            (v.detach().cpu() - state_dict[k]).flatten()
            for k, v in model.state_dict().items()])
    card, cpu = losses["card"]["loss_overall"], losses["cpu"]["loss_overall"]
    d_card, d_cpu = updates["card"], updates["cpu"]
    return {"losses_card": losses["card"], "losses_cpu": losses["cpu"],
            "loss_overall_rel_err": abs(card - cpu) / abs(cpu),
            "rtol": 1e-2,
            "update_rel_err": float((d_card - d_cpu).norm() / d_cpu.norm()),
            "update_rel_tol": 1.0,
            "params_max_abs_err": float((d_card - d_cpu).abs().max()),
            "params_tol": 2 * float(d_cpu.abs().max()),
            "update_sign_flip_share": float(
                ((d_card * d_cpu) < 0).float().mean())}


def _train_bf16_stacked(workdir, dev, base, cfg, mcfg, val_videos,
                        val_queries, host_batch) -> tuple:
    """train.main with --dtype bfloat16 --stacked_towers for 2 epochs,
    then on its checkpoint: one validation's launches, the kernel path
    against the plain path in bf16, the stacked forward against the
    sequential one and a card bf16 step against the CPU's. cfg: the f32
    run's config (its eval and train settings)."""
    import torch

    from dldkd_tpu_torch import checkpoint as ckpt_lib
    from dldkd_tpu_torch import train
    from dldkd_tpu_torch.convert import load_jax_params
    from dldkd_tpu_torch.evaluate import (_metrics_from_score_matrices,
                                          run_retrieval_eval, score_matrices)
    from dldkd_tpu_torch.metrics import build_gt_indices
    from dldkd_tpu_torch.models import DLDKD

    res = os.path.join(workdir, "train_bf16_stacked")
    _reset_counts()
    with _PlainCalls() as plain:
        t0 = time.perf_counter()
        test_metrics = train.main(base + ["--results_root", res,
                                          "--n_epoch", "2", "--dtype",
                                          "bfloat16", "--stacked_towers"])
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
    counts = _counts()
    run_dir = _run_dir(res)
    steps, sumrs, epochs = _train_history(run_dir)
    with open(os.path.join(run_dir, "ckpt", "model_cfg.json")) as f:
        saved_dtype = json.load(f)["dtype"]
    emit({"phase": "train.main bf16 stacked", "seconds": main_s,
          "steps": len(steps), "epochs_logged": epochs,
          "val_fused_sumr": sumrs,
          "loss_overall": [r["Train/loss_overall"] for r in steps],
          "launches": counts, "plain_calls": plain.calls,
          "checkpoint_dtype": saved_dtype, "test_metrics": test_metrics})
    _check_losses(steps, "train.main bf16 stacked")
    _check_launched(counts, TRAIN_KERNELS_BF16, "train.main bf16 stacked")
    if plain.calls:
        fail(f"train.main bf16 stacked: the eval path on the card ran "
             f"plain versions {plain.calls}")
    if test_metrics is None:
        fail("train.main bf16 stacked: no post-train test metrics")
    _check_metrics(test_metrics, "train.main bf16 stacked test split")
    if epochs != [0, 1] or len(sumrs) != 2 or saved_dtype != "bfloat16":
        fail(f"train.main bf16 stacked: epochs {epochs}, {len(sumrs)} "
             f"validations, checkpoint dtype {saved_dtype}")

    params, _ = ckpt_lib.restore_params_only(os.path.join(run_dir, "ckpt"))
    bf_cfg = mcfg.replace(dtype="bfloat16")
    model = load_jax_params(DLDKD(bf_cfg), params).to(dev)
    eval_cfg = cfg.eval
    _reset_counts()
    with _PlainCalls() as plain:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        val_metrics = run_retrieval_eval(model, val_videos, val_queries,
                                         eval_cfg, device=dev)
        torch.cuda.synchronize()
        val_s = time.perf_counter() - t0
    per_val = _counts()
    _check_launched(per_val, TRAIN_KERNELS_BF16, "bf16 validation")
    if plain.calls:
        fail(f"bf16 validation: plain versions ran {plain.calls}")
    k_i, k_e = score_matrices(model, val_videos, val_queries,
                              eval_cfg.eval_context_bsz,
                              eval_cfg.eval_query_bsz, dev)
    p_i, p_e = score_matrices(model, val_videos, val_queries,
                              eval_cfg.eval_context_bsz,
                              eval_cfg.eval_query_bsz, dev, plain=True)
    gt = torch.from_numpy(build_gt_indices(val_queries.video_ids,
                                           val_videos.ids)).to(dev)
    score_err = max(max_err(k_i, p_i), max_err(k_e, p_e))
    ties = _near_tie_flips(k_i, k_e, p_i, p_e, gt)
    k_fused = _metrics_from_score_matrices(k_i, k_e, gt, (0.7, 0.3))["fused"]
    p_fused = _metrics_from_score_matrices(p_i, p_e, gt, (0.7, 0.3))["fused"]
    state = {k: v.detach().cpu().clone()
             for k, v in load_jax_params(DLDKD(mcfg), params)
             .state_dict().items()}
    stacked = _stacked_vs_sequential(state, mcfg, host_batch, dev)
    step = _bf16_step_vs_cpu(state, mcfg, cfg, host_batch, dev)
    emit({"phase": "train_bf16_checkpoint", "validation_s": val_s,
          "launches_per_validation": per_val, "val_metrics": val_metrics,
          "kernel_vs_plain_scores_max_abs_err": score_err,
          "tol": TOL[("scores", "bfloat16")], **ties,
          "kernel_path_fused_sumr": k_fused["sumr"],
          "plain_path_fused_sumr": p_fused["sumr"],
          "stacked_vs_sequential_max_abs_err": stacked,
          "stacked_tol": {"float32": 1e-5, "bfloat16": 3e-2},
          "card_vs_cpu_bf16_step": step})
    if not score_err <= TOL[("scores", "bfloat16")] \
            or ties["max_crossing_gap"] > ties["near_tie_tol"]:
        fail(f"bf16 trained checkpoint: kernel vs plain scores differ by "
             f"{score_err}, rank flips {ties}")
    if not (stacked["float32"] <= 1e-5 and stacked["bfloat16"] <= 3e-2):
        fail(f"stacked vs sequential forward on the card: {stacked}")
    if not (step["loss_overall_rel_err"] <= step["rtol"]
            and step["update_rel_err"] <= step["update_rel_tol"]
            and step["params_max_abs_err"] <= step["params_tol"]):
        fail(f"bf16 train step: card vs CPU {step}")
    del k_i, k_e, p_i, p_e
    _int8_checkpoint_flips(model, val_videos, val_queries, eval_cfg, dev,
                           "int8 eval of the trained bf16 checkpoint")
    del model
    torch.cuda.empty_cache()
    return counts, per_val


def _train_bench(dev) -> list:
    """dldkd_tpu_torch.tools.train_bench in its four settings (f32 / bf16 x
    sequential / stacked), and bf16 stacked at the trainer's matmul
    precision: one record each (stage medians, samples/s, device-busy ms
    and CUDA kernels per step, peak GB)."""
    import torch

    from dldkd_tpu_torch.tools import train_bench

    recs = []
    for dtype, stacked, precision in TRAIN_BENCH["settings"]:
        rec = train_bench.bench(dtype, stacked, TRAIN_BENCH["reps"], dev,
                                precision)
        emit({"phase": "train_bench", **rec})
        if not all(math.isfinite(v) for v in rec["stages_ms"].values()) \
                or not rec["kernels_per_step"]:
            fail(f"train bench {dtype} stacked={stacked}: {rec}")
        recs.append(rec)
        torch.cuda.empty_cache()
    return recs


def phase_train(workdir: str, dev):
    """The do_tvr.sh path through dldkd_tpu_torch.train.main at full width
    on a synthetic dataset, its resume, and the measurements."""
    import numpy as np
    import torch

    from dldkd_tpu_torch import checkpoint as ckpt_lib
    from dldkd_tpu_torch import train
    from dldkd_tpu_torch.config import parse_args
    from dldkd_tpu_torch.convert import load_jax_params
    from dldkd_tpu_torch.data import TrainLoader
    from dldkd_tpu_torch.data.synthetic import generate_dataset
    from dldkd_tpu_torch.evaluate import (_metrics_from_score_matrices,
                                          run_retrieval_eval, score_matrices)
    from dldkd_tpu_torch.metrics import build_gt_indices
    from dldkd_tpu_torch.models import DLDKD

    t_phase = time.perf_counter()
    root = os.path.join(workdir, "train_data")
    generate_dataset(root, n_videos={"train": TRAIN["n_train"],
                                     "val": TRAIN["n_val"],
                                     "test": TRAIN["n_test"]},
                     frames_range=(20, 200), tokens_range=(5, 31),
                     d_student=TRAIN["d_video"], d_query=TRAIN["d_query"],
                     d_teacher=TRAIN["d_teacher"], seed=7,
                     noise=TRAIN["noise"], feature_format="npz")
    setup_s = time.perf_counter() - t_phase
    base = TRAIN_ARGS + ["--root_path", root]

    # 1. train.main: the untrained validation, 2 epochs with validation,
    # the best checkpoint, then the test split's inference
    res1 = os.path.join(workdir, "train_run")
    _reset_counts()
    with _PlainCalls() as plain:
        t0 = time.perf_counter()
        test_metrics = train.main(base + ["--results_root", res1,
                                          "--eval_untrained",
                                          "--n_epoch", "2"])
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
    main_counts = _counts()
    run_dir = _run_dir(res1)
    steps, sumrs, epochs = _train_history(run_dir)
    emit({"phase": "train.main", "seconds": main_s,
          "dataset_setup_s": setup_s, "steps": len(steps),
          "epochs_logged": epochs, "val_fused_sumr": sumrs,
          "loss_overall": [r["Train/loss_overall"] for r in steps],
          "launches": main_counts, "plain_calls": plain.calls,
          "test_metrics": test_metrics})
    _check_losses(steps, "train.main")
    _check_launched(main_counts, TRAIN_KERNELS, "train.main")
    if plain.calls:
        fail(f"train.main: the eval path on the card ran plain versions "
             f"{plain.calls}")
    if test_metrics is None:
        fail("train.main: no post-train test metrics")
    _check_metrics(test_metrics, "train.main test split")
    for rel in ("ckpt/model.ckpt", "eval.log.txt", "code.zip", "opt.json"):
        if not os.path.isfile(os.path.join(run_dir, rel)):
            fail(f"train.main: {rel} missing from the run directory")
    if epochs != [0, 1] or len(sumrs) != 3 or len(steps) != 2 * TRAIN[
            "n_train"] // TRAIN["bsz"]:
        fail(f"train.main: epochs {epochs}, {len(sumrs)} validations, "
             f"{len(steps)} steps")

    # 2. --resume from the best checkpoint to epoch 3, with --profile_dir
    # over steps [1, 6) of its first epoch; one validation
    saved = int(ckpt_lib.read_checkpoint(os.path.join(run_dir, "ckpt"))
                ["epoch"])
    res2 = os.path.join(workdir, "train_resume")
    prof_dir = os.path.join(workdir, "train_profile")
    cfg = parse_args(base + ["--results_root", res2, "--n_epoch", "3",
                             "--resume", os.path.join(run_dir, "ckpt"),
                             "--profile_dir", prof_dir, "--profile_steps",
                             str(TRAIN["profiled_steps"])])
    _reset_counts()
    t0 = time.perf_counter()
    with _PlainCalls() as plain:
        train.start_training(cfg, device=dev)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    per_val = _counts()
    r_steps, r_sumrs, r_epochs = _train_history(_run_dir(res2))
    breakdown = _trace_breakdown(os.path.join(prof_dir, "trace.json"))
    emit({"phase": "train.resume", "seconds": resume_s,
          "resumed_from_epoch": saved, "epochs_logged": r_epochs,
          "val_fused_sumr": r_sumrs, "launches_per_validation": per_val,
          "plain_calls": plain.calls})
    emit({"phase": "train_profile", "steps": TRAIN["profiled_steps"],
          **breakdown})
    _check_losses(r_steps, "train resume")
    if saved != 1 or r_epochs != [2] or len(r_sumrs) != 1:
        fail(f"train resume: from epoch {saved}, logged epochs {r_epochs}; "
             f"the resumed run must start at epoch 2")
    _check_launched(per_val, TRAIN_KERNELS, "train resume validation")
    if plain.calls:
        fail(f"train resume: plain versions ran {plain.calls}")
    if not breakdown["device_events"]:
        fail("train profile: no device events in the trace")

    # 3. on the trained checkpoint: the step's time, the validation's time,
    # the kernel path against the plain path, the card against the CPU
    mcfg, train_data, val_videos, val_queries, _ = \
        train.build_model_and_data(cfg)
    params, _ = ckpt_lib.restore_params_only(os.path.join(run_dir, "ckpt"))
    model = load_jax_params(DLDKD(mcfg), params).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    val_metrics = run_retrieval_eval(model, val_videos, val_queries, cfg.eval,
                                     device=dev)
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t0
    k_i, k_e = score_matrices(model, val_videos, val_queries,
                              cfg.eval.eval_context_bsz,
                              cfg.eval.eval_query_bsz, dev)
    p_i, p_e = score_matrices(model, val_videos, val_queries,
                              cfg.eval.eval_context_bsz,
                              cfg.eval.eval_query_bsz, dev, plain=True)
    gt = torch.from_numpy(build_gt_indices(val_queries.video_ids,
                                           val_videos.ids)).to(dev)
    k_fused = _metrics_from_score_matrices(k_i, k_e, gt, (0.7, 0.3))["fused"]
    p_fused = _metrics_from_score_matrices(p_i, p_e, gt, (0.7, 0.3))["fused"]
    score_err = max(max_err(k_i, p_i), max_err(k_e, p_e))

    loader = TrainLoader(train_data, TRAIN["bsz"], seed=cfg.train.seed,
                         query_pad_multiple=cfg.data.query_pad_multiple)
    host_batches = list(loader.epoch(0))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
               for b in host_batches]
    model.train()
    timing = _step_times(model, mcfg.replace(use_hard_negative=True),
                         cfg, batches, dev)
    step_check = _cpu_step_check(
        {k: v.detach().clone() for k, v in load_jax_params(
            DLDKD(mcfg), params).state_dict().items()},
        mcfg, cfg, host_batches[0], dev)
    emit({"phase": "train_trained_checkpoint",
          "validation_s": val_s, "val_videos": len(val_videos),
          "val_queries": len(val_queries), "val_metrics": val_metrics,
          "kernel_vs_plain_scores_max_abs_err": score_err,
          "tol": TOL[("scores", "float32")],
          "kernel_path_fused_sumr": k_fused["sumr"],
          "plain_path_fused_sumr": p_fused["sumr"],
          "bsz": TRAIN["bsz"], "queries_per_batch":
              [int((b["text_labels"] >= 0).sum()) for b in host_batches],
          **timing, "card_vs_cpu_step": step_check,
          "phase_s": time.perf_counter() - t_phase})
    if not score_err <= TOL[("scores", "float32")]:
        fail(f"trained checkpoint: kernel vs plain scores differ by "
             f"{score_err}")
    if k_fused["sumr"] != p_fused["sumr"]:
        fail(f"trained checkpoint: fused SumR {k_fused['sumr']} on the "
             f"kernels vs {p_fused['sumr']} on the plain path")
    if not step_check["ok"]:
        fail(f"train step: card vs CPU {step_check}")
    if not np.isfinite(timing["step_ms_median"]):
        fail("train step timing failed")
    del k_i, k_e, p_i, p_e
    _int8_checkpoint_flips(model, val_videos, val_queries, cfg.eval, dev,
                           "int8 eval of the trained f32 checkpoint")
    del model, batches
    torch.cuda.empty_cache()

    # 4. --dtype bfloat16 --stacked_towers: train.main for 2 epochs, its
    # validation through the bf16 kernels; then the train bench's four
    # settings
    bf_counts, bf_per_val = _train_bf16_stacked(
        workdir, dev, base, cfg, mcfg, val_videos, val_queries,
        host_batches[0])
    _train_bench(dev)
    emit({"phase": "train", "phase_s": time.perf_counter() - t_phase})
    return main_counts, per_val, bf_counts, bf_per_val


# ------------------------------------------ slice 11: teacher extraction

# openai/clip-vit-base-patch32's published widths, as its config.json
# gives them (eos_token_id 2: the legacy argmax pooling)
CLIP_B32 = {"projection_dim": 512,
            "text_config": {"hidden_size": 512, "intermediate_size": 2048,
                            "num_hidden_layers": 12,
                            "num_attention_heads": 8,
                            "max_position_embeddings": 77,
                            "vocab_size": 49408, "eos_token_id": 2},
            "vision_config": {"hidden_size": 768, "intermediate_size": 3072,
                              "num_hidden_layers": 12,
                              "num_attention_heads": 12, "image_size": 224,
                              "patch_size": 32}}
# the synthetic corpus: 64 train videos of 32 seeded uint8 frames at
# 240 x 320, their captions; the card's features held against the CPU's
# on 16 captions and 16 frames; the extraction's batch (text and frames)
TEACHER = dict(n_train=64, n_val=16, n_test=16, frames=32, height=240,
               width=320, check=16, bsz=256, seed=11, train_bsz=16)


def _clip_forward_flops(cfg, n_tokens: int, tower: str) -> float:
    """Operations of one sequence's CLIP forward (products and the
    attention's two matmuls) at n_tokens positions, with its projection
    (and, for images, the patch product)."""
    t = getattr(cfg, tower)
    d, i, n = t.hidden_size, t.intermediate_size, n_tokens
    per_layer = 2 * n * d * (4 * d + 2 * i) + 4 * n * n * d
    flops = t.num_hidden_layers * per_layer + 2 * d * cfg.projection_dim
    if tower == "vision":
        flops += 2 * (n - 1) * t.num_channels * t.patch_size ** 2 * d
    return float(flops)


def _teacher_cli(mode: str, common, extra=()) -> float:
    """python -m dldkd_tpu_torch.tools.extract_teacher in a fresh process
    on the card; its wall seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "dldkd_tpu_torch.tools.extract_teacher",
         "--mode", mode, *common, *extra], capture_output=True, text=True,
        timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        fail(f"extract_teacher --mode {mode} in a fresh process: exit "
             f"{proc.returncode}: {proc.stderr[-2000:]}")
    return time.perf_counter() - t0


def _timed_extraction(fns, cap_file, video_ids, frames_root, out_dir):
    """Both extraction loops in this process with the CLI's callables:
    captions/s and images/s (wall, ended by the copy back), the time the
    text loop spent tokenizing, the share of the video loop spent
    preprocessing (synchronized spans) and the peak device memory."""
    import torch

    from dldkd_tpu_torch.tools import extract_teacher as et

    spent = {"preprocess": 0.0, "tokenize": 0.0}

    def tokenize(texts):
        t0 = time.perf_counter()
        out = fns["tokenize"](texts)
        spent["tokenize"] += time.perf_counter() - t0
        return out

    def preprocess(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fns["preprocess"](frames)
        torch.cuda.synchronize()
        spent["preprocess"] += time.perf_counter() - t0
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    n_caps = et.extract_query_features(
        cap_file, os.path.join(out_dir, "q.hdf5"), tokenize,
        fns["encode_text"], TEACHER["bsz"], "npz")
    text_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    et.extract_video_features(
        video_ids, frames_root, os.path.join(out_dir, "v.hdf5"), preprocess,
        fns["encode_image"], TEACHER["bsz"], 0, "npz")
    video_s = time.perf_counter() - t0
    n_img = len(video_ids) * TEACHER["frames"]
    return {"captions": n_caps, "text_s": text_s,
            "captions_per_s": n_caps / text_s,
            "tokenize_s": spent["tokenize"], "images": n_img,
            "video_s": video_s, "images_per_s": n_img / video_s,
            "preprocess_s": spent["preprocess"],
            "preprocess_share": spent["preprocess"] / video_s,
            "peak_mem_bytes": torch.cuda.max_memory_allocated()}


def _video_loop_profile(fns, frames_list) -> dict:
    """One pass of preprocess + image forward over the given videos'
    frames under torch.profiler: wall ms, device busy ms by op class, the
    idle share and the longest kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for frames in frames_list:
            fns["encode_image"](fns["preprocess"](frames))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_class, by_name = {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = (e.time_range.end - e.time_range.start) / 1e3
        cls = _op_class(e.name)
        by_class[cls] = by_class.get(cls, 0.0) + ms
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + ms
    busy = sum(by_class.values())
    return {"videos": len(frames_list), "wall_ms": wall_ms,
            "busy_ms": busy, "idle_share": 1.0 - busy / wall_ms,
            "busy_ms_by_class": by_class,
            "top_kernels_ms": dict(sorted(by_name.items(),
                                          key=lambda kv: -kv[1])[:5])}


def phase_teacher(workdir: str, dev, card: str):
    """CLIP teacher extraction at ViT-B/32's published widths with seeded
    weights: the model directory in the JAX tool's layout, both modes of
    `python -m dldkd_tpu_torch.tools.extract_teacher --feature_format
    npz` in fresh processes on the card, then the checks (preprocessing
    card vs CPU bitwise, features card vs CPU, the stores complete) and
    one `train.main --debug` epoch on the extracted 512-d stores."""
    import numpy as np
    import torch

    from dldkd_tpu_torch import train
    from dldkd_tpu_torch.data.ingest import (dataset_paths, load_captions,
                                             open_features, read_video_ids)
    from dldkd_tpu_torch.data.synthetic import generate_dataset
    from dldkd_tpu_torch.models.clip import (ClipConfig, ClipModel,
                                             load_clip, save_clip)
    from dldkd_tpu_torch.tools.clip_preprocess import (
        PREPROCESSOR_NAME, ClipPreprocessor, PreprocessConfig)
    from dldkd_tpu_torch.tools.extract_teacher import build_clip_fns

    t_phase = time.perf_counter()
    cfg = ClipConfig.from_dict(CLIP_B32)
    model_dir = os.path.join(workdir, "clip-vit-base-patch32")
    model = ClipModel(cfg).init_weights(
        torch.Generator().manual_seed(TEACHER["seed"]))
    n_params = sum(p.numel() for p in model.parameters())
    save_clip(model, model_dir)
    del model
    side = cfg.vision.image_size
    pre_cfg = PreprocessConfig(shortest_edge=side, crop_size=(side, side))
    with open(os.path.join(model_dir, PREPROCESSOR_NAME), "w") as f:
        json.dump(pre_cfg.to_dict(), f)
    root = os.path.join(workdir, "data")
    generate_dataset(root, n_videos={"train": TEACHER["n_train"],
                                     "val": TEACHER["n_val"],
                                     "test": TEACHER["n_test"]},
                     frames_range=(20, 200), tokens_range=(5, 31),
                     d_student=TRAIN["d_video"], d_query=TRAIN["d_query"],
                     d_teacher=16, seed=TEACHER["seed"], feature_format="npz")
    paths = dataset_paths(root, "synthetic", "i3d")
    cap_file = paths["cap_file"]["train"]
    video_ids = read_video_ids(cap_file)
    cap_ids, captions, _, _ = load_captions(cap_file)
    frames_root = os.path.join(workdir, "frames")
    os.makedirs(frames_root)
    rng = np.random.RandomState(TEACHER["seed"])
    shape = (TEACHER["frames"], TEACHER["height"], TEACHER["width"], 3)
    for vid in video_ids:
        np.save(os.path.join(frames_root, f"{vid}.npy"),
                rng.randint(0, 256, shape, dtype=np.uint8))
    setup_s = time.perf_counter() - t_phase

    # 1. the CLI in fresh processes, writing the trainer's teacher stores
    common = ["--collection", "synthetic", "--root_path", root,
              "--clip_model", model_dir, "--feature_format", "npz",
              "--bsz", str(TEACHER["bsz"])]
    text_cli_s = _teacher_cli("text", common)
    video_cli_s = _teacher_cli("video", common,
                               ["--frames_root", frames_root])

    # 2. the stores: every caption and video, 512 wide, finite
    text_store, vid_store = (paths["teacher_text_feat"],
                             paths["teacher_vid_feat"])
    with open_features(text_store) as f:
        text_feats = {k: np.asarray(f[k]) for k in f.files}
    with open_features(vid_store) as f:
        vid_feats = {k: np.asarray(f[k]) for k in f.files}
    width = cfg.projection_dim
    stores_ok = (
        text_store.endswith(".npz") and vid_store.endswith(".npz")
        and sorted(text_feats) == sorted(cap_ids)
        and sorted(vid_feats) == sorted(video_ids)
        and all(v.shape == (width,) and np.isfinite(v).all()
                for v in text_feats.values())
        and all(v.shape == (TEACHER["frames"], width)
                and np.isfinite(v).all() for v in vid_feats.values()))

    # 3. throughput in this process, with the CLI's callables: a first
    # pass (the first calls' set-up included), then the steady pass; a
    # profile of 8 videos' loop
    fns = build_clip_fns(model_dir, device=dev)
    first = _timed_extraction(fns, cap_file, video_ids, frames_root,
                              os.path.join(workdir, "timed"))
    timing = _timed_extraction(fns, cap_file, video_ids, frames_root,
                               os.path.join(workdir, "timed"))
    loop_profile = _video_loop_profile(fns, [
        np.load(os.path.join(frames_root, f"{v}.npy"))
        for v in video_ids[:8]])

    # 4. card against CPU: the preprocessing bitwise, the features within
    # TOL on a subset, the stores' rows against the CPU's
    n = TEACHER["check"]
    frames = np.load(os.path.join(frames_root, f"{video_ids[0]}.npy"))[:n]
    px_card = ClipPreprocessor(pre_cfg, dev)(frames)
    px_cpu = ClipPreprocessor(pre_cfg, "cpu")(frames)
    pre_bitwise = bool(torch.equal(px_card.cpu(), px_cpu))
    tokens = fns["tokenize"]([captions[c] for c in cap_ids[:n]])
    card_text = fns["encode_text"](tokens)
    card_img = fns["encode_image"]({"pixel_values": px_card})
    cpu_model = load_clip(model_dir, "cpu")
    with torch.inference_mode():
        cpu_text = cpu_model.get_text_features(
            torch.from_numpy(tokens["input_ids"]),
            torch.from_numpy(tokens["attention_mask"])).numpy()
        cpu_img = cpu_model.get_image_features(px_cpu).numpy()
    del cpu_model
    errs = {
        "text": float(np.abs(card_text - cpu_text).max()),
        "image": float(np.abs(card_img - cpu_img).max()),
        "text_store": float(np.abs(np.stack(
            [text_feats[c] for c in cap_ids[:n]]) - cpu_text).max()),
        "video_store": float(np.abs(vid_feats[video_ids[0]][:n]
                                    - cpu_img).max())}
    tol = TOL[("clip", "float32")]
    text_flops = _clip_forward_flops(cfg, cfg.text.max_position_embeddings,
                                     "text")
    img_flops = _clip_forward_flops(
        cfg, (pre_cfg.crop_size[0] // cfg.vision.patch_size) ** 2 + 1,
        "vision")
    emit({"phase": "teacher", "card": card, "model": "CLIP ViT-B/32 "
          "(published widths, seeded weights)", "params": n_params,
          "setup_s": setup_s, "text_cli_process_s": text_cli_s,
          "video_cli_process_s": video_cli_s, **timing,
          "first_pass": {k: first[k] for k in (
              "text_s", "captions_per_s", "tokenize_s", "video_s",
              "images_per_s")},
          "video_loop_profile": loop_profile,
          "gflop_per_caption": text_flops / 1e9,
          "gflop_per_image": img_flops / 1e9,
          "bound_ms_text": bound(0, timing["captions"] * text_flops,
                                 "float32")[0],
          "bound_ms_video": bound(0, timing["images"] * img_flops,
                                  "float32")[0],
          "features_max_abs_err_card_vs_cpu": errs, "tol": tol,
          "feature_max_abs": float(max(np.abs(cpu_text).max(),
                                       np.abs(cpu_img).max())),
          "preprocess_card_vs_cpu_bitwise": pre_bitwise,
          "stores_complete": stores_ok, "captions": len(cap_ids),
          "videos": len(video_ids)})
    if not pre_bitwise:
        fail("teacher: the preprocessing on the card differs from the CPU's")
    if not all(v <= tol for v in errs.values()):
        fail(f"teacher: card vs CPU features {errs} > {tol}")
    if not stores_ok:
        fail("teacher: the extracted stores miss captions or videos, or "
             "hold rows that are not 512 wide and finite")

    # 5. one --debug epoch of train.main on the extracted teacher stores
    res = os.path.join(workdir, "train", "results")
    _reset_counts()
    t0 = time.perf_counter()
    train.main(TRAIN_ARGS + ["--root_path", root, "--results_root", res,
                             "--debug", "--n_epoch", "1", "--bsz",
                             str(TEACHER["train_bsz"])])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = _counts()
    steps, sumrs, _ = _train_history(
        _run_dir(os.path.join(os.path.dirname(res), "debug_results")))
    emit({"phase": "teacher train.main --debug", "seconds": train_s,
          "steps": len(steps), "val_fused_sumr": sumrs,
          "loss_overall": [r["Train/loss_overall"] for r in steps],
          "launches": counts, "phase_s": time.perf_counter() - t_phase})
    _check_losses(steps, "teacher train.main --debug")
    _check_launched(counts, TRAIN_KERNELS, "teacher train.main --debug")
    torch.cuda.empty_cache()


# each kernels-line entry's check at the streaming shapes
STREAM_CHECKS = {"sim_max": "sim_max_bf16", "sim_max_f32": "sim_max_f32",
                 "sim_max_int8": "sim_max_int8",
                 "sim_max_exact": "sim_max_exact",
                 "query_tower": "query_tower_bfloat16",
                 "context_tower": "context_tower_bfloat16",
                 "query_tower_f32": "query_tower_float32",
                 "context_tower_f32": "context_tower_float32",
                 "context_tower_q8": "context_tower_q8_bfloat16"}


def _bench_launches(bench_launches, counter: str) -> dict:
    """A kernel's launches on each path of phase_benches that ran it."""
    return {path: c[counter] for path, c in bench_launches.items()
            if c.get(counter)}


# a check record's keys that the kernels line carries
BRIEF_KEYS = ("shape", "max_abs_err", "tol", "kernel_ms", "device_ms",
              "wrapper_ms", "plain_ms", "bound_ms", "bound_by",
              "vs_plain_towers_max_levels", "shapes_of")
# each kernel's check at the sharded evals' shapes (_parallel_shape_checks)
PARALLEL_CHECKS = {"sim_max": "sim_max_bfloat16",
                   "sim_max_f32": "sim_max_float32",
                   "sim_max_int8": "sim_max_int8",
                   "query_tower": "query_tower_bfloat16",
                   "context_tower": "context_tower_bfloat16",
                   "query_tower_f32": "query_tower_float32",
                   "context_tower_f32": "context_tower_float32",
                   "context_tower_q8": "context_tower_q8",
                   "query_tower_1br": "query_tower_1br",
                   "context_tower_1br": "context_tower_1br"}


def _brief(rec) -> dict:
    return {k: rec[k] for k in BRIEF_KEYS if k in rec}


def _parallel_launches(parallel_launches, counter: str) -> dict:
    """A kernel's launches on each path of phase_parallel that ran it."""
    return {path: c[counter] for path, c in parallel_launches.items()
            if c.get(counter)}


def kernels_line(checks, launches, int8_launches, serve_launches,
                 train_launches, stream, q8t_checks, artifact_launches,
                 bench, parallel, epilogues, entry):
    """Every ported kernel: its source, the TPU kernel it replaces, its
    launches on its main path and its phase-3 numbers; beside them, its
    launches in the train phase (train.main: three validations and the
    test split's inference, all f32) and in one validation, and in the
    bf16 stacked run (two validations and the test split's inference, all
    bf16) and one bf16 validation, read from the same counter (the scorer
    and the chains are counted by dtype); its
    check at the streaming shapes and its launches on each streaming path
    (`phase_streaming`); its launches on each path of `phase_benches`
    (`bench_launches`: stage_bench, the port bench) and, for the bf16
    two-branch towers, the int8 epilogue and the int8 scorer, its check at
    the shapes those paths give it (`bench_check`). The one-branch tower
    launches (`query_tower_1br`, `context_tower_1br`: the Pallas
    `fused_query_tower` and `fused_context_tower`) have their own entries,
    on stage_bench's one-branch rows, with the check at stage_bench's
    shapes (11,264 queries, 2,304 videos) and phase 3's beside it. Every
    entry of a kernel that `phase_parallel` or `phase_serving_mesh` ran
    carries its launches on each of those paths (`parallel_launches`: the
    sharded serving routes and their one-branch twin, the sharded evals,
    the one-branch twin, the NCCL world of one) and its check at the
    shapes the sharded evals give it (`parallel_check`). The two-branch
    tower entries carry their launch's fused epilogues (`epilogues`: the
    LayerNorms, and the query tower's pooling, in the whole-row products,
    timed against the products alone, with `torch.nn.functional.layer_norm`
    as the LayerNorm's yardstick) and the query towers their check on 136
    tokens (`check_l136`) and at the ActivityNet and Charades query width
    of 1,024 (`check_d1024`). Each kernel that the in-process validations
    of `phase_entry_scripts` ran carries its launches there
    (`entry_launches`, by dataset)."""
    bench_launches, bench_checks = bench
    parallel_launches, parallel_checks = parallel
    # (launch counter, source, TPU kernel replaced, check record, path whose
    # launches count)
    mma = "dldkd_tpu_torch/csrc/sim_max_mma.cu"
    sources = {
        "sim_max": ("sim_max_bf16", mma, "dldkd_tpu/ops/pallas/sim_max.py:36",
                    ("sim_max", "bfloat16"), "tvr_eval bfloat16",
                    launches["bfloat16"]),
        "sim_max_f32": ("sim_max_f32", mma,
                        "dldkd_tpu/ops/pallas/sim_max.py:36",
                        ("sim_max", "float32"), "tvr_eval float32",
                        launches["float32"]),
        "sim_max_int8": ("sim_max_int8", mma,
                         "dldkd_tpu/ops/pallas/sim_max.py:195",
                         ("sim_max_int8", TVR["query_bsz"]),
                         "tvr_int8_eval", int8_launches),
        "sim_max_exact": ("sim_max_exact", mma,
                          "dldkd_tpu/ops/pallas/sim_max.py:66",
                          ("sim_max_exact", SERVE["query_bsz"]),
                          "serving two_stage_dense",
                          serve_launches["two_stage_dense"]),
        "query_tower": ("query_tower_bf16",
                        "dldkd_tpu_torch/csrc/tower_mma.cu",
                        "dldkd_tpu/ops/pallas/query_tower.py:211",
                        ("query_tower", "bfloat16", 2), "tvr_eval bfloat16",
                        launches["bfloat16"]),
        "context_tower": ("context_tower_bf16",
                          "dldkd_tpu_torch/csrc/tower_mma.cu",
                          "dldkd_tpu/ops/pallas/query_tower.py:246",
                          ("context_tower", "bfloat16", 2),
                          "tvr_eval bfloat16", launches["bfloat16"]),
        "query_tower_f32": ("query_tower_f32",
                            "dldkd_tpu_torch/csrc/tower_mma.cu",
                            "dldkd_tpu/ops/pallas/query_tower.py:211",
                            ("query_tower", "float32", 2), "tvr_eval float32",
                            launches["float32"]),
        "context_tower_f32": ("context_tower_f32",
                              "dldkd_tpu_torch/csrc/tower_mma.cu",
                              "dldkd_tpu/ops/pallas/query_tower.py:246",
                              ("context_tower", "float32", 2),
                              "tvr_eval float32", launches["float32"]),
        "context_tower_q8": ("context_tower_q8",
                             "dldkd_tpu_torch/csrc/tower.cu",
                             "dldkd_tpu/ops/pallas/query_tower.py:144",
                             ("context_tower_q8", "bfloat16", 2),
                             "tvr_int8_eval", int8_launches),
    }
    main_counts, per_val, bf_counts, bf_per_val = train_launches
    stream_checks, stream_launches = stream
    kernels = []
    for name, (counter, src, replaces, key, path, counts) in sources.items():
        rec = checks[key]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": counts[counter],
                        "launches_path": path,
                        "train_launches": main_counts[counter],
                        "launches_per_validation": per_val[counter],
                        "train_launches_bf16_stacked": bf_counts[counter],
                        "launches_per_bf16_validation": bf_per_val[counter],
                        "max_abs_err": rec["max_abs_err"],
                        "ms": rec["kernel_ms"], "plain_ms": rec["plain_ms"],
                        "bound_ms": rec["bound_ms"],
                        "bound_by": rec["bound_by"], "library_ms": None,
                        "product_ms": rec.get("product_ms")})
        if "device_ms" in rec:
            kernels[-1]["device_ms"] = rec["device_ms"]
        kernels[-1]["bench_launches"] = _bench_launches(bench_launches,
                                                        counter)
        kernels[-1]["parallel_launches"] = _parallel_launches(
            parallel_launches, counter)
        kernels[-1]["entry_launches"] = {p: c[counter]
                                         for p, c in entry.items()
                                         if c.get(counter)}
        at_bench = {"query_tower": "query_tower_dual",
                    "context_tower": "context_tower_dual",
                    "sim_max_int8": "sim_max_int8",
                    "context_tower_q8": "context_tower_q8"}.get(name)
        if at_bench:
            kernels[-1]["bench_check"] = _brief(bench_checks[at_bench])
        if name in PARALLEL_CHECKS:
            kernels[-1]["parallel_check"] = _brief(
                parallel_checks[PARALLEL_CHECKS[name]])
        kernels[-1]["streaming_check"] = stream_checks[STREAM_CHECKS[name]]
        kernels[-1]["streaming_launches"] = {
            p: c[counter] for p, c in stream_launches.items()
            if c.get(counter)}
        if name.startswith(("query_tower", "context_tower")) \
                and name != "context_tower_q8":
            # the chain (both dtypes): tower_mma.cu's normalization,
            # products (LayerNorms and pooling in their epilogues) and
            # attention; tower.cu's int8 epilogue after the video tower's
            kind, dtype = key[0].split("_")[0], key[1]
            n = TVR["query_bsz"] if kind == "query" else TVR["context_bsz"]
            kernels[-1]["chain_sources"] = [src] + (
                ["dldkd_tpu_torch/csrc/tower.cu"] if kind == "context"
                else [])
            kernels[-1]["epilogues"] = _epilogue_brief(
                epilogues[(kind, n, dtype)])
            if kind == "query":
                kernels[-1]["check_l136"] = _brief(
                    checks[("query_tower", dtype, 2, "L136")])
                kernels[-1]["check_d1024"] = _brief(
                    checks[("query_tower", dtype, 2, "d1024")])
        if name == "context_tower_q8":
            # the in-place epilogue at the streaming block (2,048 videos),
            # at the serving index build's shape, its share of the bound,
            # and the bf16 reciprocal's exhaustive check
            kernels[-1]["streaming_check"]["kernel_ms_2048"] = \
                q8t_checks["bfloat16"]["in_place_epilogue_ms"]
            kernels[-1]["streaming_check"]["device_ms_2048"] = \
                q8t_checks["bfloat16"]["in_place_device_ms"]
            kernels[-1]["share_of_bound"] = rec["share_of_bound"]
            kernels[-1]["serving_check"] = {
                dtype: {k: checks[("context_tower_q8_serving", dtype)][k]
                        for k in ("rows", "device_ms", "bound_ms",
                                  "share_of_bound", "bitwise_vs_plain")}
                for dtype in ("bfloat16", "float32")}
            kernels[-1]["reciprocal_mismatches"] = checks[
                "q8_reciprocal_exhaustive"]["mismatches"]
    # the one-branch launches: on stage_bench's one-branch rows (bf16),
    # checked at their shapes
    for name, kind, replaces in (
            ("query_tower_1br", "query",
             "dldkd_tpu/ops/pallas/query_tower.py:196"),
            ("context_tower_1br", "context",
             "dldkd_tpu/ops/pallas/query_tower.py:229")):
        rec = bench_checks[f"{kind}_tower_1br"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "dldkd_tpu_torch/csrc/tower_mma.cu",
            "replaces": replaces,
            "launches": bench_launches["stage_bench"][name],
            "launches_path": "stage_bench (1-branch rows)",
            "bench_launches": _bench_launches(bench_launches, name),
            "parallel_launches": _parallel_launches(parallel_launches,
                                                    name),
            "max_abs_err": rec["max_abs_err"], "ms": rec["kernel_ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None,
            "device_ms": rec["device_ms"],
            "chain_sources": ["dldkd_tpu_torch/csrc/tower_mma.cu"] + (
                ["dldkd_tpu_torch/csrc/tower.cu"] if kind == "context"
                else []),
            "check_shape": rec["shape"],
            "phase3_check": _brief(checks[(f"{kind}_tower", "bfloat16",
                                           1)]),
            "parallel_check": _brief(parallel_checks[PARALLEL_CHECKS[name]])})
    # the epilogue's transposed write (q8_transposed): on the path of the
    # artifact phase's transposed emission of the corpus; its numbers from
    # the check at 2,048 videos (bf16, the serving dtype)
    rec = q8t_checks["bfloat16"]
    kernels.append({
        "name": "context_tower_q8_t", "route": "cuda",
        "source": "dldkd_tpu_torch/csrc/tower.cu",
        "replaces": "dldkd_tpu/ops/pallas/query_tower.py:168",
        "launches": artifact_launches["artifacts_q8_transposed"][
            "context_tower_q8_t"],
        "launches_path": "artifacts q8_transposed",
        "bench_launches": _bench_launches(bench_launches,
                                          "context_tower_q8_t"),
        "max_abs_err": rec["max_abs_err"], "ms": rec["kernel_ms"],
        "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"], "library_ms": None,
        "in_place_epilogue_ms": rec["in_place_epilogue_ms"],
        "device_ms": rec["device_ms"], "share_of_bound": rec["share_of_bound"],
        "float32": {k: q8t_checks["float32"][k] for k in (
            "kernel_ms", "device_ms", "plain_ms", "bound_ms",
            "share_of_bound", "in_place_epilogue_ms")}})
    return kernels


def main() -> None:
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a GPU")
    try:
        import dldkd_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port is not importable from here: {e}")
    check_no_jax()

    t_start = time.perf_counter()
    kind, count, card = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    checks = phase_kernels(dev)
    phase_tower_shapes(dev)
    epilogues = phase_epilogues(dev)
    checks.update(phase_kernels_slice2(dev))
    q8t_checks = _q8t_kernel_check(dev)
    # the drivers' packed-dataset cache lives and dies with this run
    with tempfile.TemporaryDirectory(prefix="chip_smoke_packs_") as packs:
        os.environ["DLDKD_PACK_CACHE_DIR"] = packs
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
            root = phase_infer(workdir)
            entry = phase_entry_scripts(workdir, dev)
            phase_serving_cli(workdir, root)
        launches, videos, queries = phase_tvr_eval(dev)
        stream = phase_streaming(dev, videos, queries)
        int8_launches = phase_int8_eval(dev, videos, queries)
        serve_launches = phase_serving(dev, videos, queries)
        artifact_launches = phase_artifacts(dev, videos, queries)
        with tempfile.TemporaryDirectory(
                prefix="chip_smoke_parallel_") as workdir:
            parallel = phase_parallel(workdir, dev, videos, queries)
        parallel[0].update(phase_serving_mesh(dev, videos, queries))
        del videos, queries
        bench = phase_benches(dev, card)
        with tempfile.TemporaryDirectory(
                prefix="chip_smoke_teacher_") as workdir:
            phase_teacher(workdir, dev, card)
        with tempfile.TemporaryDirectory(
                prefix="chip_smoke_train_") as workdir:
            train_launches = phase_train(workdir, dev)

    kernels = kernels_line(checks, launches, int8_launches,
                           serve_launches, train_launches, stream,
                           q8t_checks, artifact_launches, bench,
                           parallel, epilogues, entry)
    check_no_jax()
    emit({"seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        _gloo_dp_rank(int(sys.argv[2]), sys.argv[3])
    else:
        main()
