"""The device mesh of the port (port of dldkd_tpu/parallel/mesh.py).

The JAX package lays one 1-D mesh over its devices and lets sharding
annotations place the work: training shards the batch, the retrieval eval
shards the corpus. The port's mesh is the same 1-D axis made explicit: a
global count of shards, the devices this process holds shards on, and the
process group that joins the processes (None in one process).

- Training runs one process per GPU (`torchrun`): each process holds one
  shard, its own device, and the group is the world.
- The corpus-sharded eval also runs in one process over several devices
  (`make_mesh()` takes every visible GPU), and a device may appear more
  than once: several shards on one card, or on the CPU in the tests. That
  is the counterpart of the JAX suite's virtual CPU devices
  (`--xla_force_host_platform_device_count`, tests/conftest.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch


class Mesh(NamedTuple):
    """`devices`: this process's shards, one device each, in shard order;
    `group`: the process group (None in one process). Every process of
    the group holds the same number of shards; process r's are the global
    shards [r * len(devices), (r + 1) * len(devices))."""

    devices: Tuple[torch.device, ...]
    group: Optional[object] = None

    @property
    def n_processes(self) -> int:
        if self.group is None:
            return 1
        import torch.distributed as dist

        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        if self.group is None:
            return 0
        import torch.distributed as dist

        return dist.get_rank(self.group)

    @property
    def size(self) -> int:
        """The global shard count (the JAX mesh's `devices.size`)."""
        return len(self.devices) * self.n_processes

    def local_shards(self):
        """(global shard index, device) of each of this process's shards."""
        first = self.rank * len(self.devices)
        return [(first + i, d) for i, d in enumerate(self.devices)]


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None, group=None) -> Mesh:
    """A mesh over `devices` (default: every visible CUDA device), the
    first `n_devices` of them if given. Asking for CUDA without a GPU
    raises."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is available; pass "
                "devices=['cpu', ...] for a mesh on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if n_devices is not None:
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("make_mesh: no devices")
    for d in devs:
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"make_mesh: {d} asked for, but no CUDA "
                               "device is available")
    return Mesh(tuple(devs), group)


def shard_rows(n: int, mesh: Mesh):
    """Each global shard's row range of an axis of n rows padded to a
    multiple of the mesh size: shard s holds rows [s * per, (s + 1) * per)
    of the padded axis, per = ceil(n / size); rows past n are padding."""
    per = -(-n // mesh.size)
    return [slice(s * per, (s + 1) * per) for s in range(mesh.size)]
