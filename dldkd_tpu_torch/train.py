"""The training loop and its CLI (port of dldkd_tpu/train.py).

Reference flow (method/train.py): epoch loop over shuffled video batches,
per-epoch distillation/alpha/belta decays, per-epoch validation retrieval,
best-SumR checkpointing, early stop, then test-split inference.

The train step (forward, backward, the global-norm clip, BertAdam) is plain
PyTorch autograd: the JAX package's step calls no Pallas kernel. With
--dtype bfloat16 the towers compute in bf16 while the parameters, the
gradients, BertAdam's moments and every loss stay f32; --stacked_towers
runs both branches' towers as one stacked computation
(models/stacked.py). The per-epoch validation runs on the resident eval
engine (`evaluate.py`) in the model's dtype, so on a CUDA device it goes
through the hand-written tower and scoring kernels of that dtype, on
weights packed anew at every validation. Loss values stay on
the device until the epoch ends. Dropout masks and negative samples come
from one `torch.Generator` on the device, seeded from seed + 1 and saved in
every checkpoint, so `--resume` continues a run exactly. Checkpoints are
in the JAX package's format (`checkpoint.py`), in both directions.

Several GPUs: one process per GPU under torchrun (`main` joins the
process group, parallel/multihost.py). The run is then data-parallel with
the global batch's losses (parallel/train_dp.py) over d processes, d the
largest count up to the world size that divides --bsz and
--query_pad_multiple (`dp_mesh_size`, dldkd_tpu/train.py:221-231); the
short last batch is dropped, the processes agree on a stop every
PREEMPT_SYNC_STEPS steps and at each epoch's end, the validation runs
sharded over the processes (parallel/eval_shard.py), and only process 0
writes the run's files (checkpoints, train.log.txt, metrics.jsonl,
code.zip, the --profile_dir trace). Unlike the JAX trainer, which leaves
the devices past d idle, a world larger than d raises before training:
idle processes would hang in the collectives. The compile cache has no
counterpart; `--rng_impl` is accepted and means nothing here.

Run: python -m dldkd_tpu_torch.train --collection tvr --root_path $root \
        --visual_feature i3d_resnet ... [--torch_device cuda|cpu]
     torchrun --nproc_per_node N -m dldkd_tpu_torch.train ...
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
import sys
import time
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from dldkd_tpu_torch import checkpoint as ckpt_lib
from dldkd_tpu_torch import float32_matmul_precision, resolve_device
from dldkd_tpu_torch.config import Config, ModelConfig, parse_args
from dldkd_tpu_torch.convert import (load_jax_params, opt_state_from_jax,
                                     opt_state_to_jax,
                                     params_from_state_dict)
from dldkd_tpu_torch.data import (BigFile, TrainLoader, device_prefetch,
                                  pack_query_set, pack_train_dataset,
                                  pack_video_corpus, read_dict)
from dldkd_tpu_torch.data.ingest import dataset_paths, read_video_ids
from dldkd_tpu_torch.evaluate import run_retrieval_eval
from dldkd_tpu_torch.infer import start_inference
from dldkd_tpu_torch.models import DLDKD
from dldkd_tpu_torch.models.objective import (LossScalars, check_trainable,
                                              compute_losses)
from dldkd_tpu_torch.optim import BertAdam, default_wd_mask, schedules
from dldkd_tpu_torch.parallel import make_dp_train_step, make_mesh
from dldkd_tpu_torch.parallel.multihost import (broadcast_object,
                                                maybe_initialize_distributed,
                                                process_device,
                                                process_group,
                                                replicate_multihost,
                                                shard_batch_multihost)
from dldkd_tpu_torch.parallel.train_dp import average_gradients
from dldkd_tpu_torch.utils import (AverageMeter, MetricsWriter,
                                   PreemptionGuard, make_code_zip,
                                   setup_logging, tracing)
from dldkd_tpu_torch.utils.preemption import agree_should_stop

LOSS_KEYS = ("loss_overall", "inher_trip", "inher_nce", "explore_trip",
             "explore_nce", "kl", "kl_intra")
# a data-parallel run's processes agree on a stop every this many steps
# (and at each epoch's end): the host sync is amortized over the steps,
# and preemption grace windows are tens of seconds
PREEMPT_SYNC_STEPS = 32


def clip_grads(grads, grad_clip: float):
    """The global-norm clip before the optimizer (reference
    train.py:149-150); BertAdam then clips each tensor on its own."""
    if grad_clip <= 0:
        return grads
    gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    scale = torch.clamp(grad_clip / (gnorm + 1e-6), max=1.0)
    return [g * scale for g in grads]


def train_step(model: DLDKD, mcfg: ModelConfig, tcfg, optimizer: BertAdam,
               batch: Dict[str, torch.Tensor], generator: torch.Generator,
               scalars: LossScalars, group=None) -> Dict[str, torch.Tensor]:
    """One optimization step in place (train.py:57-80); returns the loss
    dict, detached, on the device. Its parts are the profiler ranges
    train_step/forward_losses, train_step/backward (the gradient
    all-reduce and the global clip included) and train_step/optimizer.
    group: the data-parallel step (parallel/train_dp.py) on `batch` from
    `shard_batch_multihost`: the gradients are averaged over the
    processes before the clip."""
    model.train()
    with tracing.span("train_step/forward_losses"):
        loss, loss_dict = compute_losses(model, batch, generator, mcfg, tcfg,
                                         scalars, group=group)
    with tracing.span("train_step/backward"):
        params = list(optimizer.params.values())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, params)]
        if group is not None:
            grads = average_gradients(grads, group)
        grads = clip_grads(grads, tcfg.grad_clip)
    with tracing.span("train_step/optimizer"):
        optimizer.step(grads)
    return {k: v.detach() for k, v in loss_dict.items()}


def dp_mesh_size(n_train: int, bsz: int, query_pad_multiple: int,
                 world: int) -> int:
    """The data-parallel mesh size (dldkd_tpu/train.py:221-231): the
    largest d <= world dividing bsz and query_pad_multiple; 1 when the
    train split holds less than one batch (dropping the short batch would
    leave no step)."""
    if n_train < bsz:
        return 1
    for d in range(min(world, math.gcd(bsz, query_pad_multiple)), 0, -1):
        if bsz % d == 0 and query_pad_multiple % d == 0:
            return d
    return 1


def build_model_and_data(cfg: Config):
    """Pack the train split and the val split, and resolve the
    data-dependent model config. With cfg.data.pack_cache (the default;
    --no_pack_cache turns it off) the packed arrays come from the
    content-keyed cache (`data/cache.py`), as dldkd_tpu/train.py:86-95
    takes them: a second run maps them and reads no BigFile or HDF5."""
    paths = dataset_paths(cfg.data.root_path, cfg.data.collection,
                          cfg.data.visual_feature)
    if cfg.data.pack_cache:
        from dldkd_tpu_torch.data import cache as pack_cache

        train_data = pack_cache.cached_train_pack(
            paths, cfg.data.max_ctx_l, cfg.data.max_desc_l)
        val_videos = pack_cache.cached_corpus_pack(paths, "val",
                                                   cfg.data.max_ctx_l)
        val_queries = pack_cache.cached_query_pack(paths, "val",
                                                   cfg.data.max_desc_l)
        # the feature width from the packed arrays: the BigFile header's
        visual_dim = int(train_data.videos.feats.shape[-1])
    else:
        visual_feats = BigFile(paths["visual_feat_dir"])
        video2frames = read_dict(paths["video2frames"])
        visual_dim = visual_feats.ndims
        train_data = pack_train_dataset(
            paths["cap_file"]["train"], visual_feats, video2frames,
            paths["text_feat"], paths["teacher_vid_feat"],
            paths["teacher_text_feat"],
            max_ctx_l=cfg.data.max_ctx_l, max_desc_l=cfg.data.max_desc_l)
        val_videos = pack_video_corpus(
            read_video_ids(paths["cap_file"]["val"]), visual_feats,
            video2frames, max_ctx_l=cfg.data.max_ctx_l)
        val_queries = pack_query_set(paths["cap_file"]["val"],
                                     paths["text_feat"],
                                     max_desc_l=cfg.data.max_desc_l)
    mcfg = cfg.model.replace(
        visual_input_size=visual_dim,               # discovered at runtime
        query_input_size=cfg.data.q_feat_size,      # (reference train.py:286-289)
        max_ctx_l=cfg.data.max_ctx_l,
        max_desc_l=cfg.data.max_desc_l,
    )
    return mcfg, train_data, val_videos, val_queries, paths


def init_params(mcfg: ModelConfig, seed: int, device=None) -> DLDKD:
    """The seeded model (reference init, model.py:80-93), drawn on the CPU
    from a generator seeded with `seed` and moved to `device`, so every
    device starts from the same weights."""
    model = DLDKD(mcfg).init_weights(torch.Generator().manual_seed(seed))
    return model.to(resolve_device(device or "cpu"))


def epoch_scalars(cfg: Config, epoch: int, device=None) -> LossScalars:
    """This epoch's decay scalars as float32 tensors (train.py:168-179)."""
    t = cfg.train
    kd = schedules.distill_weight(
        t.distill_loss_decay, epoch, exponential_k=t.exponential_k,
        linear_k=t.linear_k, linear_b=t.linear_b, sigmoid_k=t.sigmoid_k)
    alpha = schedules.alpha_schedule(
        t.alpha_decay, epoch, t.alpha, t.n_epoch, t.exponential_k,
        t.selfDistil_sigmoid_k)
    belta = schedules.belta_schedule(
        t.belta_decay, epoch, t.belta, t.n_epoch, t.exponential_k,
        t.selfDistil_sigmoid_k)
    return LossScalars(*(torch.tensor(v, dtype=torch.float32, device=device)
                         for v in (kd, alpha, belta)))


def _state(model, optimizer, epoch, best_score, generator) -> dict:
    """The full training state in the JAX package's checkpoint layout;
    "rng" holds the generator's state."""
    return {"params": params_from_state_dict(model.state_dict()),
            "opt_state": opt_state_to_jax(optimizer.state_dict()),
            "epoch": int(epoch), "best_score": float(best_score),
            "rng": generator.get_state().numpy()}


def _restore_rng(generator: torch.Generator, payload, seed: int,
                 logger) -> None:
    """Set the generator from a port checkpoint's state; a JAX checkpoint's
    key (uint32 (2,)) has no torch counterpart, so re-seed from seed."""
    payload = np.asarray(payload)
    state = generator.get_state()
    if payload.dtype == np.uint8 and payload.shape == tuple(state.shape):
        generator.set_state(torch.from_numpy(payload.copy()))
        return
    generator.manual_seed(seed)
    logger.info("the checkpoint's rng (%s %s) is not this device's "
                "torch.Generator state: re-seeded the generator from %d",
                payload.dtype, payload.shape, seed)


def start_training(cfg: Config, device=None, preempt_guard=None,
                   initial_params=None, epoch_order=None) -> str:
    """Train on `device` (default: the config's torch_device, "cuda"
    unless set); returns the results dir.

    initial_params: optional JAX parameter tree ({"params": ...}, numpy
    leaves) to start from instead of the seeded init: finetuning, and
    trajectory tests that start both packages from the same weights.
    epoch_order: optional per-epoch video-ID sequences replayed verbatim by
    the loader (see TrainLoader)."""
    dev = resolve_device(device or cfg.torch_device)
    check_trainable(cfg.model, cfg.train)
    logger = setup_logging(cfg.results_dir)
    with float32_matmul_precision(cfg.model.matmul_precision), \
            torch.autograd.set_detect_anomaly(cfg.debug_nans):
        return _train(cfg, dev, logger, preempt_guard, initial_params,
                      epoch_order)


def _train(cfg: Config, dev: torch.device, logger, preempt_guard,
           initial_params, epoch_order) -> str:
    if cfg.train.rng_impl != "threefry2x32":
        logger.info("--rng_impl %s has no PyTorch counterpart: every "
                    "training stream comes from one torch.Generator",
                    cfg.train.rng_impl)
    group = process_group()
    n_proc = 1 if group is None else dist.get_world_size(group)
    # one writer of the run's files in a data-parallel run
    writes = group is None or dist.get_rank(group) == 0
    if group is not None:
        dev = process_device(dev)
    if writes:
        make_code_zip(os.path.dirname(os.path.abspath(__file__)),
                      os.path.join(cfg.results_dir, "code.zip"))

    t0 = time.time()
    mcfg, train_data, val_videos, val_queries, _ = build_model_and_data(cfg)
    logger.info("packed %d train videos / %d captions, %d val videos / "
                "%d val queries in %.1fs",
                len(train_data.videos), len(train_data.queries),
                len(val_videos), len(val_queries), time.time() - t0)

    if initial_params is not None:
        model = load_jax_params(DLDKD(mcfg), initial_params).to(dev)
    else:
        model = init_params(mcfg, cfg.train.seed, dev)
    model.train()
    named = dict(model.named_parameters())
    n_params = sum(p.numel() for p in named.values())
    logger.info("model parameters: %.2fM on %s", n_params / 1e6, dev)

    # a process group: data-parallel over every process, each on its GPU
    mesh = None
    n_mesh = 1
    if group is not None:
        n_mesh = dp_mesh_size(len(train_data.videos), cfg.train.bsz,
                              cfg.data.query_pad_multiple, n_proc)
        if n_mesh < n_proc:
            raise ValueError(
                f"data-parallel training over {n_proc} processes needs a "
                f"train split of at least one batch and --bsz and "
                f"--query_pad_multiple divisible by the process count; "
                f"this run divides over {n_mesh}: launch {n_mesh} "
                f"processes")
        mesh = make_mesh(devices=[dev], group=group)
        replicate_multihost(model, group)
        logger.info("data-parallel: %d of %d devices / %d processes",
                    n_mesh, n_proc, n_proc)

    # data-parallel runs drop the short trailing batch: its video axis
    # would not divide the processes
    loader = TrainLoader(train_data, cfg.train.bsz, seed=cfg.train.seed,
                         query_pad_multiple=cfg.data.query_pad_multiple,
                         drop_last=n_mesh > 1, epoch_order=epoch_order)
    t_total = loader.steps_per_epoch() * cfg.train.n_epoch
    lr_sched = schedules.make_lr_schedule(
        "warmup_linear", cfg.train.lr_warmup_proportion, float(t_total))
    optimizer = BertAdam(named, cfg.train.lr, lr_sched,
                         weight_decay=cfg.train.wd,
                         wd_mask=default_wd_mask(named))

    writer = MetricsWriter(cfg.tensorboard_log_dir) if writes else None
    rng_seed = cfg.train.seed + 1
    generator = torch.Generator(device=dev).manual_seed(rng_seed)
    best_score, es_cnt = 0.0, 0
    global_step = 0
    own_guard = preempt_guard is None
    preempt = PreemptionGuard().install() if own_guard else preempt_guard

    start_epoch = -1 if cfg.eval_untrained else 0
    if cfg.resume:
        # exact mid-training resume: params + optimizer + epoch + generator
        state = ckpt_lib.restore_checkpoint(cfg.resume)
        load_jax_params(model, state["params"])
        optimizer.load_state_dict(opt_state_from_jax(state["opt_state"]))
        best_score = float(state["best_score"])
        _restore_rng(generator, state["rng"], rng_seed, logger)
        start_epoch = int(state["epoch"]) + 1
        global_step = loader.steps_per_epoch() * start_epoch
        logger.info("resumed from %s: epoch %d, best sumr %.1f",
                    cfg.resume, start_epoch, best_score)

    def save(ckpt_dir, epoch):
        if writes:
            ckpt_lib.save_checkpoint(ckpt_dir, _state(
                model, optimizer, epoch, best_score, generator), mcfg)

    def log_line(text):
        if writes:
            with open(cfg.train_log_filepath, "a") as f:
                f.write(text)

    try:
        for epoch in range(start_epoch, cfg.train.n_epoch):
            if epoch >= 0:
                run_cfg = mcfg
                if (cfg.train.hard_negative_start_epoch != -1
                        and epoch >= cfg.train.hard_negative_start_epoch):
                    run_cfg = mcfg.replace(
                        use_hard_negative=True,
                        hard_pool_size=cfg.train.hard_pool_size)
                scalars = epoch_scalars(cfg, epoch, dev)
                logger.info("epoch %d: kd_weight=%.4f alpha=%.4f belta=%.4f "
                            "hard_neg=%s", epoch, float(scalars.kd_weight),
                            float(scalars.alpha), float(scalars.belta),
                            run_cfg.use_hard_negative)
                data_t, step_t = AverageMeter(), AverageMeter()
                prof = None
                pending = []
                batches = loader.epoch(epoch)
                step = functools.partial(train_step, model, run_cfg,
                                         cfg.train, optimizer)
                if mesh is not None:
                    batches = (shard_batch_multihost(b, group)
                               for b in batches)
                    step = make_dp_train_step(model, run_cfg, cfg.train,
                                              optimizer, mesh)
                t_fetch = time.time()
                for batch_idx, batch in enumerate(
                        device_prefetch(batches, dev)):
                    data_t.update(time.time() - t_fetch)
                    if cfg.profile_dir and writes \
                            and epoch == max(start_epoch, 0):
                        # steps [1, 1 + profile_steps): step 0 warms up
                        if batch_idx == 1:
                            prof = tracing.start_profile(dev)
                        elif batch_idx == 1 + cfg.profile_steps and prof:
                            logger.info("profiler trace written to %s",
                                        tracing.stop_profile(
                                            prof, cfg.profile_dir))
                            prof = None
                    t_step = time.time()
                    loss_dict = step(batch, generator, scalars)
                    # loss scalars stay on the device until the epoch ends:
                    # fetching them here would sync the host every step
                    pending.append((global_step, loss_dict))
                    step_t.update(time.time() - t_step)
                    global_step += 1
                    t_fetch = time.time()
                    if n_proc == 1:
                        if preempt.should_stop:
                            break
                    elif (batch_idx + 1) % PREEMPT_SYNC_STEPS == 0 and \
                            agree_should_stop(preempt.should_stop, group):
                        preempt.trigger()
                        break
                    if cfg.debug and batch_idx == 3:
                        break
                if prof:  # epoch shorter than profile_steps
                    logger.info("profiler trace written to %s",
                                tracing.stop_profile(prof, cfg.profile_dir))
                meters = {k: AverageMeter() for k in LOSS_KEYS}
                if pending:
                    vals = torch.stack([torch.stack([ld[k] for k in LOSS_KEYS])
                                        for _, ld in pending]).cpu().numpy()
                    for (step_i, _), row in zip(pending, vals):
                        for k, v in zip(LOSS_KEYS, row):
                            meters[k].update(v)
                        if writer:
                            writer.scalars({f"Train/{k}": v for k, v in
                                            zip(LOSS_KEYS, row)}, step_i)
                loss_str = " ".join(f"{k} {m.avg:.4f}"
                                    for k, m in meters.items())
                log_line(f"{time.strftime('%Y_%m_%d_%H_%M_%S')} [Epoch] "
                         f"{epoch:03d} [Loss] {loss_str}\n")
                logger.info("epoch %d: %s | data %.3fs/step step %.3fs/step",
                            epoch, loss_str, data_t.avg, step_t.avg)
                # preemption exit after the loss flush; the interrupted
                # epoch is recorded as not yet done: --resume replays it
                # from its start with the mid-epoch parameters
                if agree_should_stop(preempt.should_stop, group):
                    preempt.trigger()
                    preempt_dir = cfg.ckpt_dir + "_preempt"
                    save(preempt_dir, epoch - 1)
                    logger.info(
                        "preempted at epoch %d step %d: resume checkpoint "
                        "written to %s (pass --resume %s)", epoch,
                        global_step, preempt_dir, preempt_dir)
                    break

            # this epoch's weights, packed anew by the engine; eval mode
            # and no autograd inside, training mode again after; sharded
            # over the processes of a data-parallel run
            metrics = run_retrieval_eval(model, val_videos, val_queries,
                                         cfg.eval, mesh=mesh, device=dev)
            for branch, m in metrics.items():
                logger.info("val %s: r1/5/10/100 %.1f/%.1f/%.1f/%.1f sumr "
                            "%.1f map %.4f", branch, m["r1"], m["r5"],
                            m["r10"], m["r100"], m["sumr"], m["map"])
            if writer:
                writer.scalars({f"Val/{b}_sumr": m["sumr"]
                                for b, m in metrics.items()},
                               max(global_step, 0))
            score = metrics["fused"]["sumr"]

            if score > best_score:
                best_score, es_cnt = score, 0
                save(cfg.ckpt_dir, epoch)
                logger.info("checkpoint updated (sumr %.1f)", best_score)
            else:
                es_cnt += 1
                if cfg.train.max_es_cnt != -1 and es_cnt > cfg.train.max_es_cnt:
                    log_line(f"Early Stop at epoch {epoch}")
                    logger.info("early stop at epoch %d", epoch)
                    break
            # a SIGTERM during the validation: this epoch is done (eval and
            # best checkpoint above), so --resume continues at epoch + 1
            if agree_should_stop(preempt.should_stop, group):
                preempt.trigger()
                preempt_dir = cfg.ckpt_dir + "_preempt"
                save(preempt_dir, epoch)
                logger.info(
                    "preempted during epoch %d eval: resume checkpoint "
                    "written to %s (pass --resume %s)", epoch,
                    preempt_dir, preempt_dir)
                break
            if cfg.debug:
                break
    finally:
        if writer:
            writer.close()
        if own_guard:
            # restore the previous SIGTERM disposition even when an
            # exception escapes training
            preempt.__exit__(None, None, None)
    if group is not None:
        # process 0's checkpoints are on disk before any process reads them
        dist.barrier(group)
    if preempt.should_stop:
        logger.info("training preempted; best val sumr so far %.1f",
                    best_score)
    else:
        logger.info("training done; best val sumr %.1f", best_score)
    return cfg.results_dir


def main(argv=None):
    """The CLI: train on --torch_device, then (unless preempted or --debug)
    test-split inference on the best checkpoint (reference
    train.py:335-344); returns its metric dicts."""
    cfg = parse_args(argv)
    maybe_initialize_distributed(cfg.torch_device)  # no-op without torchrun
    with PreemptionGuard() as guard:
        # every process evaluates the run dir process 0 wrote
        results_dir = broadcast_object(
            start_training(cfg, preempt_guard=guard), process_group())
        preempted = guard.should_stop
    # handlers restored here: a SIGTERM during post-train inference
    # terminates the process normally (nothing would poll the guard)
    if preempted:
        print("preempted: skipping post-train inference; resume with "
              f"--resume {cfg.ckpt_dir}_preempt", file=sys.stderr)
        return None
    if cfg.debug:
        return None
    test_cfg = dataclasses.replace(
        cfg, eval=dataclasses.replace(cfg.eval, model_dir=results_dir,
                                      eval_split_name="test"))
    return start_inference(test_cfg)


if __name__ == "__main__":
    main()
