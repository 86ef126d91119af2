"""The multi-process runtime (port of dldkd_tpu/parallel/multihost.py).

The JAX package runs one program per host under `jax.distributed`; the
port runs one process per GPU under `torchrun`, which sets RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT (the counterparts of
JAX_PROCESS_ID, JAX_NUM_PROCESSES and JAX_COORDINATOR_ADDRESS). Every
process builds the same seeded model and the same global host batch from
the same loader seed; each takes its slice of the student inputs
(`shard_batch_multihost`). Without a process group every helper here is
the single-process case.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def maybe_initialize_distributed(device="cuda") -> bool:
    """Join the process group that torchrun's variables describe: NCCL for
    a CUDA `device` (after selecting cuda:LOCAL_RANK), gloo for the CPU.
    Without those variables, or with a group already joined, nothing
    happens. Returns True if this call joined a group."""
    if dist.is_initialized() or not all(k in os.environ
                                        for k in TORCHRUN_ENV):
        return False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=(f"tcp://{os.environ['MASTER_ADDR']}:"
                     f"{os.environ['MASTER_PORT']}"),
        world_size=int(os.environ["WORLD_SIZE"]),
        rank=int(os.environ["RANK"]))
    return True


def process_group():
    """The default process group when one is joined, else None."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def process_slice(n: int, group=None) -> slice:
    """This process's contiguous share of a global leading axis of n rows
    (n must divide by the process count)."""
    if group is None:
        return slice(0, n)
    pc, pi = dist.get_world_size(group), dist.get_rank(group)
    if n % pc:
        raise ValueError(f"axis {n} not divisible by {pc} processes")
    per = n // pc
    return slice(pi * per, (pi + 1) * per)


def process_device(device) -> torch.device:
    """`device` with this process's GPU index filled in ("cuda" ->
    cuda:current_device(), which maybe_initialize_distributed set to
    LOCAL_RANK); other devices as they are."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def default_mesh(device):
    """The mesh an entry point shards its corpus over on `device`
    (dldkd_tpu/infer.py:60-68): this process's device in the joined
    process group, else every GPU when there are several, else None."""
    from dldkd_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device(device)
    group = process_group()
    if group is not None:
        return make_mesh(devices=[process_device(dev)], group=group)
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        return make_mesh()
    return None


def collective_device(group) -> torch.device:
    """Where a collective's tensors live: this process's GPU under NCCL,
    the CPU otherwise."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def replicate_multihost(model: torch.nn.Module, group=None
                        ) -> torch.nn.Module:
    """Every process's model takes process 0's weights (one broadcast per
    tensor); one process: the model as it is."""
    if group is not None and dist.get_world_size(group) > 1:
        src = dist.get_global_rank(group, 0)
        with torch.no_grad():
            for t in model.state_dict().values():
                dist.broadcast(t, src=src, group=group)
    return model


def shard_batch_multihost(batch: Dict[str, np.ndarray], group=None
                          ) -> Dict[str, np.ndarray]:
    """The host batch with this process's rows of the student inputs
    (`student_videos`, `student_text`); the masks, the teacher features
    and the labels stay whole, because every process computes the whole
    batch's losses (parallel/train_dp.py). One process: the batch."""
    if group is None:
        return batch
    out = dict(batch)
    for key in ("student_videos", "student_text"):
        out[key] = batch[key][process_slice(batch[key].shape[0], group)]
    return out


def broadcast_object(obj, group=None):
    """Process 0's `obj` on every process (pickled); one process: obj."""
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                               group=group)
    return box[0]
