"""Data-parallel training with the global batch's losses (port of
dldkd_tpu/parallel/train_dp.py).

The batch-coupled losses (NCE denominators, triplet negatives) need the
whole batch's score matrix. The JAX package all-gathers an operand of the
similarity product over the mesh and psums the gradient, so its step is
exactly the single-device step; plain DDP's per-replica losses would be a
different, weaker objective (dldkd_tpu/parallel/train_dp.py:5-14). The
port keeps the global semantics, one process per GPU:

- each process encodes its rows of the videos and of the queries, its
  dropout masks drawn at the global batch's shape (`BatchShard`);
- the four tower outputs are all-gathered in rank order (`all_gather_rows`,
  whose backward all-reduces the gathered gradient and keeps this rank's
  rows);
- every process computes the whole batch's losses from the gathered
  outputs and the whole host batch (teacher features, masks, labels), the
  negatives drawn from the same generator state on every process;
- the parameter gradients are all-reduced and divided by the world size,
  then the global clip and BertAdam run identically everywhere.

Unlike the JAX step, the loss is computed on every process rather than
partitioned: it is small next to the towers, and every process then holds
the same losses and generator state (`--resume` needs one state).
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import torch
import torch.distributed as dist

from dldkd_tpu_torch.models.components import BatchShard
from dldkd_tpu_torch.parallel.mesh import Mesh
from dldkd_tpu_torch.parallel.multihost import process_slice


class _AllGatherRows(torch.autograd.Function):
    """Forward: every rank's rows concatenated in rank order. Backward:
    the gathered gradient summed over the ranks, this rank's rows (every
    rank computes the same loss, so each rank's parameter gradient is then
    world x its rows' share; `average_gradients` divides)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        ctx.rows = process_slice(x.shape[0] * dist.get_world_size(group),
                                 group)
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad[ctx.rows], None


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's x (equal shapes) stacked on the leading axis in rank
    order, differentiable."""
    return _AllGatherRows.apply(x, group)


def batch_shard(generator: torch.Generator, group) -> BatchShard:
    """The dropout generator of this rank's shard of the global batch."""
    return BatchShard(generator, dist.get_rank(group),
                      dist.get_world_size(group))


def local_rows(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's rows of a global-batch tensor."""
    return x[process_slice(x.shape[0], group)]


def gather_outputs(outs, group):
    """The towers' ((ctx_i, ctx_e), (q_i, q_e)) of every rank's rows, as
    the single-device forward returns them for the whole batch."""
    return tuple(tuple(None if t is None else all_gather_rows(t, group)
                       for t in pair) for pair in outs)


def average_gradients(grads: Sequence[torch.Tensor], group
                      ) -> List[torch.Tensor]:
    """The mean over the ranks of each gradient: one all-reduce (SUM) of
    the flattened gradients, divided by the world size."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    return [f.view_as(g) for f, g in
            zip(flat.split([g.numel() for g in grads]), grads)]


def make_dp_train_step(model, mcfg, tcfg, optimizer, mesh: Mesh):
    """The data-parallel step over `mesh`'s process group:
    step(batch, generator, scalars) -> the loss dict, where `batch` is
    `shard_batch_multihost`'s (this rank's student rows, the rest whole)
    on this rank's device."""
    from dldkd_tpu_torch.train import train_step

    return functools.partial(train_step, model, mcfg, tcfg, optimizer,
                             group=mesh.group)

