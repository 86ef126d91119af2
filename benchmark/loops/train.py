"""The train loop: the program's training loop, as its trainer runs it.

Set-up makes the training pool (host numpy arrays, `data.TrainData`, as
the packer hands it) and the weights from the seed, and builds one
object: the program's model, its BertAdam (the trainer's warmup-linear
schedule over the published split's steps), the step generator and a
`TrainLoader`. It drives that object from the seed through its first
`checked_steps` steps by the window's own call and feed (the trainer's
loop, train.py: `TrainLoader.epoch` -> `device_prefetch` ->
`train.train_step`, each epoch's scalars from `train.epoch_scalars`,
losses kept on the card), keeping the losses, each leaf's first gradient
as BertAdam got it (from its first moment after one step) and the
parameters after those steps. The window goes on with the same loop,
without a sync per step, until `--seconds` have passed; one read of the
last step's loss fixes its end. A traced run then traces `traced_steps`
more steps, outside the window.

train_videos_per_s: the videos of every step in the window / the window.
train.input_wait_ms (harness span): host time a step waits for its
batch from the prefetch iterator.

Once the window has closed and the peak memory is read, the reference
(`reference/train_ref.py`) runs the same first steps from the seeded
weights and the host inputs, with its own batches, schedule, optimizer
and a generator seeded alike.
"""

from __future__ import annotations

import functools
import itertools
import math
import time
from typing import Dict

import numpy as np
import torch

from benchmark import harness, inputs
from benchmark.cost import model_ops
from benchmark.loops import common
from benchmark.reference import train_ref

TRAIN_KEYS = ("lr", "lr_warmup_proportion", "wd", "n_epoch", "bsz",
              "grad_clip", "hard_negative_start_epoch", "hard_pool_size",
              "distill_loss_decay", "exponential_k", "sigmoid_k",
              "selfDistil_sigmoid_k", "kl_intra_weight", "inher_nce_weight",
              "explore_nce_weight", "alpha", "belta", "alpha_decay",
              "belta_decay")


def t_total(cfg: dict) -> int:
    """The schedule's length: the published split's steps per epoch
    times the epochs, as the trainer computes it on the whole split."""
    return math.ceil(cfg["n_train_split"] / cfg["bsz"]) * cfg["n_epoch"]


def seeds(seed: int):
    """The loader's and the step generator's seeds, from the run's."""
    return seed % (2**31 - 1), (seed * 7919 + 1) % 2**63


def run(cell: harness.Cell, seed: int, seconds: float, traced: bool,
        device: torch.device, t_start: float) -> harness.Result:
    from dldkd_tpu_torch import float32_matmul_precision, train
    from dldkd_tpu_torch.config import Config, TrainConfig
    from dldkd_tpu_torch.data import TrainLoader, device_prefetch
    from dldkd_tpu_torch.data.ingest import (PackedQueries, PackedVideos,
                                             TrainData)
    from dldkd_tpu_torch.optim import BertAdam, default_wd_mask, schedules

    cfg, mix = cell.config, cell.mix
    cfg = dict(cfg, t_total=t_total(cfg),
               use_hard_negative=cfg["hard_negative_start_epoch"] == 0)
    data = inputs.train_inputs(cfg, mix, seed, device)
    nv = cfg["n_train_videos"]
    per = cfg["captions_per_video"]
    cap_video = np.repeat(np.arange(nv), per)
    pool = TrainData(
        videos=PackedVideos(data["vfeats"], data["vmask"],
                            inputs.ids("v", nv), data["tvfeats"]),
        queries=PackedQueries(data["qfeats"], data["qmask"],
                              [f"v{v}#{i}" for i, v in enumerate(cap_video)],
                              [f"v{v}" for v in cap_video],
                              data["tqfeats"]),
        vid_cap_index=data["caps"])
    base = inputs.weights(cfg, seed, device)
    model = common.port_model(cfg, base, device).train()
    named = dict(model.named_parameters())
    tcfg = TrainConfig(**{k: cfg[k] for k in TRAIN_KEYS})
    run_cfg = Config(model=common.model_config(cfg), train=tcfg)
    optimizer = BertAdam(named, tcfg.lr, schedules.make_lr_schedule(
        "warmup_linear", tcfg.lr_warmup_proportion, float(cfg["t_total"])),
        weight_decay=tcfg.wd, wd_mask=default_wd_mask(named))
    loader_seed, gen_seed = seeds(seed)
    loader = TrainLoader(pool, tcfg.bsz, seed=loader_seed,
                         query_pad_multiple=cfg["query_pad_multiple"])
    generator = torch.Generator(device=device).manual_seed(gen_seed)

    current = {}

    def feed():
        """(epoch, scalars, batch) as the trainer's epoch loop yields
        them."""
        for epoch in itertools.count():
            scalars = train.epoch_scalars(run_cfg, epoch, device)
            current["epoch"] = loader.epoch(epoch)
            current["prefetch"] = device_prefetch(current["epoch"], device)
            for batch in current["prefetch"]:
                yield epoch, scalars, batch

    def stop_feed():
        """End the epoch's batches where they are, so the prefetch thread
        finishes and lets go of the pool."""
        while True:
            try:
                current["epoch"].close()
                break
            except ValueError:   # the thread is inside it: try again
                time.sleep(0.001)
        for _ in current["prefetch"]:
            pass
        it.close()

    def step_fn(epoch):
        mcfg = run_cfg.model
        if (tcfg.hard_negative_start_epoch != -1
                and epoch >= tcfg.hard_negative_start_epoch):
            mcfg = mcfg.replace(use_hard_negative=True,
                                hard_pool_size=tcfg.hard_pool_size)
        return functools.partial(train.train_step, model, mcfg, tcfg,
                                 optimizer)

    n_check = int(mix["checked_steps"])
    spans: Dict[str, float] = {}
    n_traced = int(mix["traced_steps"]) if traced else 0
    window = common.TracedWindow(device) if traced else None
    it = feed()
    with float32_matmul_precision(cfg["matmul_precision"]):
        prog = {"losses": []}
        for i in range(n_check):
            epoch, scalars, batch = next(it)
            out = step_fn(epoch)(batch, generator, scalars)
            prog["losses"].append(out["loss_overall"])
            if i == 0:
                prog["grad_norms"] = {n: m.norm() / (1 - optimizer.b1)
                                      for n, m in optimizer.m.items()}
        prog["change"] = {n: (p.detach() - base[n]).norm()
                          for n, p in named.items()}
        common.sync(device)
        setup_s = time.perf_counter() - t_start
        common.log(f"set-up {setup_s:.3f} s")
        steps, last = 0, None
        t0 = time.perf_counter()
        deadline = t0 + seconds
        marks = []
        while steps < 1 or time.perf_counter() < deadline:
            with common.span("bench/next_batch", spans):
                epoch, scalars, batch = next(it)
            last = step_fn(epoch)(batch, generator, scalars)
            steps += 1
            marks.append(time.perf_counter())
        float(last["loss_overall"])
        t_end = time.perf_counter()
        per16 = [(b - a) / 16 * 1e3 for a, b in zip(marks[::16],
                                                    marks[16::16])]
        common.log("ms a step, 16 at a time: "
                   + " ".join(f"{t:.1f}" for t in per16))
        wait_s = spans.get("bench/next_batch", 0.0)
        if window is not None:
            # the traced steps follow the window and are not in it
            window.start()
            for _ in range(n_traced):
                with common.span("bench/next_batch", spans):
                    epoch, scalars, batch = next(it)
                with common.span("bench/train_step", spans):
                    step_fn(epoch)(batch, generator, scalars)
            window.stop()
    stop_feed()
    window_s = t_end - t0
    peak = common.memory_peak(device)
    prog = {"losses": [float(x) for x in prog["losses"]],
            "grad_norms": {n: float(v) for n, v in
                           prog["grad_norms"].items()},
            "change": {n: float(v) for n, v in prog["change"].items()}}
    del model, named, optimizer, loader, it
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    reference = train_ref.reference_steps(base, cfg, data, loader_seed,
                                          gen_seed, n_check, device)
    checks = train_ref.compare_train(prog, reference)
    common.log(f"losses {prog['losses']} reference {reference['losses']}")
    common.log(f"reference and comparison {time.perf_counter() - t_ref:.3f}"
               " s")
    return harness.Result(
        attempted=steps, failed=0,
        metrics={"train_videos_per_s": steps * tcfg.bsz / window_s,
                 "setup_s": setup_s},
        checks=checks, window_s=window_s, units=steps,
        memory_peak_bytes=peak,
        extra={"traced_steps": n_traced, "input_wait_s": wait_s},
        trace=window.trace if window is not None else None,
        work={"flops": model_ops.train_step_flops(cfg)})
