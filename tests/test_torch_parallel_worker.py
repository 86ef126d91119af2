"""Worker of tests/test_torch_parallel.py's gloo worlds; it holds no test.

Usage: python tests/test_torch_parallel_worker.py <world> <rank> <port> \
           step <dir> | cycle <data_root> <results_root> | serve <dir>

With world > 1 each process joins a gloo group on localhost:<port>
through `maybe_initialize_distributed` (torchrun's variables set here);
world 1 is the plain single-process run, no group. Imports no JAX; prints
one JSON line.

Modes:
  step   the data-parallel step (`make_dp_train_step`) of each setting in
         <dir>/spec.json on <dir>/batch.npz from <dir>/init.pt; rank 0
         saves the losses and the updated parameters to <dir>/dp.pt; then
         the stop agreement probes; then the sharded eval of the model
         <dir>/eval_model.pt on <dir>/eval.npz over the group, two shards
         a process, on each route of spec["eval_routes"].
  cycle  the whole training run (`train.start_training`) on a dataset:
         2 epochs with per-epoch validation, then a run whose preemption
         guard is latched on rank 0 only.
  serve  corpus-sharded serving over the group, two shards a process
         (tests/test_torch_serving_mesh.py): for each route of
         <dir>/spec.json, the model <dir>/model.pt indexes the corpus of
         <dir>/data.npz and searches its queries, saves the index to
         <dir>/group_<route>, then loads <dir>/single_<route> and searches
         again.
"""

import functools
import glob
import json
import logging
import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def step_once(setting, batch, state, seed, scalars, group=None,
              device="cpu"):
    """One training step of `setting` ({"model": ModelConfig keywords,
    "train": TrainConfig keywords}) from the state dict `state` on the
    numpy `batch`, its generator seeded with `seed`, on `device`: the
    data-parallel step over `group`, or the single-device
    `train.train_step` without one. Returns (loss dict of floats, updated
    state dict on the CPU)."""
    import torch

    from dldkd_tpu_torch.config import ModelConfig, TrainConfig
    from dldkd_tpu_torch.models import DLDKD
    from dldkd_tpu_torch.models.objective import LossScalars
    from dldkd_tpu_torch.optim import BertAdam, default_wd_mask
    from dldkd_tpu_torch.parallel import (make_dp_train_step, make_mesh,
                                          shard_batch_multihost)
    from dldkd_tpu_torch.train import train_step

    mcfg = ModelConfig(**setting["model"])
    tcfg = TrainConfig(**setting["train"])
    model = DLDKD(mcfg)
    model.load_state_dict(state)
    model.to(device)
    named = dict(model.named_parameters())
    opt = BertAdam(named, tcfg.lr, None, wd_mask=default_wd_mask(named))
    gen = torch.Generator(device=device).manual_seed(seed)
    scal = LossScalars(*(torch.tensor(v, dtype=torch.float32, device=device)
                         for v in scalars))
    if group is None:
        step = functools.partial(train_step, model, mcfg, tcfg, opt)
    else:
        batch = shard_batch_multihost(batch, group)
        step = make_dp_train_step(model, mcfg, tcfg, opt,
                                  make_mesh(devices=[device], group=group))
    losses = step({k: torch.from_numpy(v).to(device)
                   for k, v in batch.items()}, gen, scal)
    return ({k: float(v) for k, v in losses.items()},
            {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()})


def _step_mode(rank, group, d):
    import numpy as np
    import torch

    from dldkd_tpu_torch.utils.preemption import agree_should_stop

    with open(os.path.join(d, "spec.json")) as f:
        spec = json.load(f)
    batch = dict(np.load(os.path.join(d, "batch.npz")))
    state = torch.load(os.path.join(d, "init.pt"))
    results, checksums = {}, {}
    for name, setting in spec["settings"].items():
        losses, params = step_once(setting, batch, state, spec["seed"],
                                   spec["scalars"], group)
        results[name] = {"losses": losses, "params": params}
        checksums[name] = float(sum(p.double().abs().sum()
                                    for p in params.values()))
    if rank == 0:
        torch.save(results, os.path.join(d, "dp.pt"))
    return {"losses": {n: r["losses"] for n, r in results.items()},
            "checksums": checksums,
            "agree_one": agree_should_stop(rank == 0, group),
            "agree_none": agree_should_stop(False, group),
            "eval": _group_eval(d, spec, group)}


def _group_eval(d, spec, group):
    """{route: metric dicts} of the sharded eval over the group."""
    import numpy as np
    import torch

    from dldkd_tpu_torch.config import EvalConfig, ModelConfig
    from dldkd_tpu_torch.data.ingest import PackedQueries, PackedVideos
    from dldkd_tpu_torch.evaluate import run_retrieval_eval
    from dldkd_tpu_torch.models import DLDKD
    from dldkd_tpu_torch.parallel import make_mesh

    data = np.load(os.path.join(d, "eval.npz"))
    videos = PackedVideos(feats=data["vfeats"], mask=data["vmask"],
                          ids=list(data["vids"]))
    queries = PackedQueries(feats=data["qfeats"], mask=data["qmask"],
                            cap_ids=list(data["cap_ids"]),
                            video_ids=list(data["qvids"]))
    model = DLDKD(ModelConfig(**spec["eval_model"]))
    model.load_state_dict(torch.load(os.path.join(d, "eval_model.pt")))
    model.eval()
    mesh = make_mesh(devices=["cpu", "cpu"], group=group)
    out = {}
    for route, kw in spec["eval_routes"].items():
        out[route] = run_retrieval_eval(model, videos, queries,
                                        EvalConfig(**kw), mesh=mesh)
    return out


def _serve_mode(d):
    """{route: {"built" | "loaded": {"ids", "scores"}}} of the group's
    Retriever on each route."""
    import numpy as np
    import torch

    from dldkd_tpu_torch.config import ModelConfig
    from dldkd_tpu_torch.data.ingest import PackedVideos
    from dldkd_tpu_torch.models import DLDKD
    from dldkd_tpu_torch.parallel import make_mesh
    from dldkd_tpu_torch.parallel.multihost import process_group
    from dldkd_tpu_torch.serving import Retriever

    with open(os.path.join(d, "spec.json")) as f:
        spec = json.load(f)
    data = np.load(os.path.join(d, "data.npz"))
    videos = PackedVideos(feats=data["feats"], mask=data["mask"],
                          ids=[f"v{i}" for i in range(len(data["feats"]))])
    model = DLDKD(ModelConfig(**spec["model"]))
    model.load_state_dict(torch.load(os.path.join(d, "model.pt")))
    mesh = make_mesh(devices=["cpu", "cpu"], group=process_group())
    out = {}
    for route, kw in spec["routes"].items():
        mode = spec["modes"][route]
        if mode is None:
            os.environ.pop("DLDKD_DENSE_RESCORE", None)
        else:
            os.environ["DLDKD_DENSE_RESCORE"] = mode
        r = Retriever(model.eval(), mesh=mesh, device="cpu", **kw)
        out[route] = {}
        r.index(videos)
        for what in ("built", "loaded"):
            scores, ids = r.search(data["qf"], data["qm"], spec["k"])
            out[route][what] = {"ids": ids.tolist(),
                                "scores": scores.tolist()}
            if what == "built":
                r.save_index(os.path.join(d, f"group_{route}"))
                r.load_index(os.path.join(d, f"single_{route}"))
    return out


class _Messages(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _cycle_mode(rank, data_root, res_root):
    """Training twice (full, then preempted), per run the per-epoch
    losses and validation SumRs as this process logged them, and which
    files it wrote."""
    from dldkd_tpu_torch import train
    from dldkd_tpu_torch.config import (Config, DataConfig, EvalConfig,
                                        ModelConfig, TrainConfig)
    from dldkd_tpu_torch.utils import MetricsWriter, PreemptionGuard

    # no TensorBoard writer (its import loads TensorFlow)
    train.MetricsWriter = lambda d: MetricsWriter(d, tensorboard=False)

    def make_cfg(exp_id, n_epoch):
        return Config(
            exp_id=exp_id, torch_device="cpu",
            results_root=os.path.join(res_root, f"p{rank}"),
            model=ModelConfig(inheritance_hidden=8, exploration_hidden=8,
                              n_heads=2, double_branch=True,
                              label_style="soft", max_ctx_l=8, max_desc_l=4),
            train=TrainConfig(lr=1e-3, n_epoch=n_epoch, bsz=16, seed=3,
                              distill_loss_decay="exp", max_es_cnt=10),
            data=DataConfig(root_path=data_root, collection="synthetic",
                            visual_feature="i3d", q_feat_size=12,
                            max_ctx_l=8, max_desc_l=4,
                            query_pad_multiple=16),
            eval=EvalConfig(eval_query_bsz=16, eval_context_bsz=8),
        ).finalize()

    def run(cfg, guard=None):
        messages = _Messages()
        logger = logging.getLogger("dldkd_tpu_torch")
        logger.addHandler(messages)
        try:
            train.start_training(cfg, device="cpu", preempt_guard=guard)
        finally:
            logger.removeHandler(messages)
        text = "\n".join(messages.lines)
        return {
            "losses": [float(v) for v in re.findall(
                r"epoch \d+: loss_overall (\S+)", text)],
            "sumrs": [float(v) for v in re.findall(
                r"val fused: .* sumr (\S+) map", text)],
            "data_parallel": re.findall(r"data-parallel: .*", text),
            "train_log": os.path.exists(cfg.train_log_filepath),
            "metrics_jsonl": os.path.exists(os.path.join(
                cfg.tensorboard_log_dir, "metrics.jsonl")),
            "best_ckpt": bool(glob.glob(os.path.join(cfg.ckpt_dir,
                                                     "model.ckpt"))),
            "preempt_ckpt": bool(glob.glob(os.path.join(
                cfg.ckpt_dir + "_preempt", "model.ckpt"))),
        }

    full = run(make_cfg("dp_epoch", 2))
    guard = PreemptionGuard()
    if rank == 0:
        guard.trigger()
    return {"full": full, "preempt": run(make_cfg("dp_preempt", 3), guard)}


def main():
    world, rank, port, mode = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    sys.path.insert(0, REPO)
    import torch

    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    from dldkd_tpu_torch.parallel.multihost import (
        maybe_initialize_distributed, process_group)

    if world > 1:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                          MASTER_PORT=port)
        assert maybe_initialize_distributed("cpu")
    group = process_group()
    if mode == "step":
        out = _step_mode(rank, group, sys.argv[5])
    elif mode == "serve":
        out = _serve_mode(sys.argv[5])
    else:
        out = _cycle_mode(rank, sys.argv[5], sys.argv[6])
    out["rank"] = rank
    if group is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
