"""Multi-GPU training and corpus-sharded eval (port of
dldkd_tpu/parallel/): the mesh (`mesh.py`), the multi-process runtime
(`multihost.py`), the data-parallel step with the global batch's losses
(`train_dp.py`) and the corpus-sharded eval engines (`eval_shard.py`,
reached through `evaluate.run_retrieval_eval(mesh=...)`).
The JAX package's `batch_shardings`, `replicated` and `shard_batch` place
arrays on a single-process mesh; the port trains one process per GPU, so
`shard_batch_multihost` takes their place."""

from dldkd_tpu_torch.parallel.eval_shard import sharded_score_matrices
from dldkd_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_rows
from dldkd_tpu_torch.parallel.multihost import (
    maybe_initialize_distributed,
    shard_batch_multihost,
)
from dldkd_tpu_torch.parallel.train_dp import make_dp_train_step

__all__ = [
    "Mesh",
    "make_mesh",
    "shard_rows",
    "make_dp_train_step",
    "sharded_score_matrices",
    "maybe_initialize_distributed",
    "shard_batch_multihost",
]
