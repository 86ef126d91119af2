"""Test-split inference from a saved checkpoint (port of dldkd_tpu/infer.py).

Reference method/eval.py start_inference (eval.py:285-322): restore the
run's opt.json, rebuild the model from the saved model_cfg.json, load the
weights of ckpt/model.ckpt (the JAX package's format, read without JAX),
encode the test corpus and report retrieval metrics. With several GPUs
the corpus is sharded (parallel/eval_shard.py): over every visible GPU in
one process, or over the processes under torchrun (one GPU each; only
process 0 writes eval.log.txt).

--profile_dir DIR traces the eval with torch.profiler: DIR/trace.json
(chrome trace: the eval's spans, `utils/tracing.py`, beside the host's ops
and the card's kernels) and DIR/counts.json (its counters).

Run: python -m dldkd_tpu_torch.infer --model_dir <results_dir> \
        --root_path $root --collection tvr --visual_feature i3d_resnet \
        [--torch_device cuda|cpu] [--profile_dir DIR]
"""

from __future__ import annotations

import logging
import time

import torch

from dldkd_tpu_torch import checkpoint as ckpt_lib
from dldkd_tpu_torch import float32_matmul_precision, resolve_device
from dldkd_tpu_torch.config import Config, parse_args
from dldkd_tpu_torch.convert import load_jax_params
from dldkd_tpu_torch.data import (BigFile, pack_query_set, pack_video_corpus,
                                  read_dict)
from dldkd_tpu_torch.data.ingest import dataset_paths, read_video_ids
from dldkd_tpu_torch.evaluate import run_retrieval_eval
from dldkd_tpu_torch.models import DLDKD
from dldkd_tpu_torch.parallel.multihost import (default_mesh,
                                                maybe_initialize_distributed)
from dldkd_tpu_torch.utils import tracing

logger = logging.getLogger("dldkd_tpu_torch")


def start_inference(cfg: Config, split: str = "test", device=None):
    """Metric dicts {'inher', 'explore', 'fused'} of the checkpoint in
    cfg's model_dir on `split`, computed on `device` (default: the
    config's torch_device, "cuda" unless set), under the run's
    --matmul_precision (as dldkd_tpu/infer.py:27-29 applies it)."""
    dev = resolve_device(device or cfg.torch_device)
    with float32_matmul_precision(cfg.model.matmul_precision):
        return _inference(cfg, split, dev)


def _inference(cfg: Config, split: str, dev: torch.device):
    model_dir = cfg.eval.model_dir or cfg.results_dir
    ckpt_dir = f"{model_dir}/ckpt"
    mcfg = ckpt_lib.load_model_cfg(ckpt_dir)
    model = DLDKD(mcfg)
    params, epoch = ckpt_lib.restore_params_only(ckpt_dir)
    load_jax_params(model, params)
    model.eval()
    logger.info("restored checkpoint from epoch %d", epoch)

    videos, queries = pack_split(cfg, split, mcfg)

    # the corpus sharded over the processes of a group, or over every
    # visible GPU of this process (dldkd_tpu/infer.py:60-68)
    mesh = default_mesh(dev)
    writes = mesh is None or mesh.rank == 0
    prof = tracing.start_profile(dev) if cfg.profile_dir and writes else None
    try:
        with torch.no_grad():
            metrics = run_retrieval_eval(model, videos, queries, cfg.eval,
                                         mesh=mesh, device=dev)
    finally:
        if prof is not None:
            logger.info("profiler trace written to %s",
                        tracing.stop_profile(prof, cfg.profile_dir))
    lines = []
    for branch, m in metrics.items():
        line = ("{} {}: r_1_5_10_100 [{:.1f}, {:.1f}, {:.1f}, {:.1f}] | "
                "recall sum {:.1f} | mAP {:.4f}".format(
                    split, branch, m["r1"], m["r5"], m["r10"], m["r100"],
                    m["sumr"], m["map"]))
        logger.info("%s", line)
        lines.append(line)
    # append-only eval log in the run dir, as the JAX package keeps it
    if writes:
        with open(f"{model_dir}/eval.log.txt", "a") as f:
            f.write(time.strftime("%Y_%m_%d_%H_%M_%S") + "\n"
                    + "\n".join(lines) + "\n")
    return metrics


def pack_split(cfg: Config, split: str, mcfg):
    """The split's corpus and queries, packed (BigFile and feature stores
    -> padded arrays), through the content-keyed pack cache
    (`data/cache.py`) unless cfg.data.pack_cache is off (--no_pack_cache),
    as dldkd_tpu/infer.py:40-44 packs them."""
    paths = dataset_paths(cfg.data.root_path, cfg.data.collection,
                          cfg.data.visual_feature)
    if cfg.data.pack_cache:
        from dldkd_tpu_torch.data import cache as pack_cache

        return (pack_cache.cached_corpus_pack(paths, split, mcfg.max_ctx_l),
                pack_cache.cached_query_pack(paths, split, mcfg.max_desc_l))
    videos = pack_video_corpus(
        read_video_ids(paths["cap_file"][split]),
        BigFile(paths["visual_feat_dir"]), read_dict(paths["video2frames"]),
        max_ctx_l=mcfg.max_ctx_l)
    queries = pack_query_set(paths["cap_file"][split], paths["text_feat"],
                             max_desc_l=mcfg.max_desc_l)
    return videos, queries


def main(argv=None):
    cfg = parse_args(argv, test=True, finalize=False)
    maybe_initialize_distributed(cfg.torch_device)  # no-op without torchrun
    return start_inference(cfg)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    main()
