"""The eval engine's one staging path, `evaluate._blocks_on_device`, on the
CPU: no thread and no pinned memory, the rows of each block as host
tensors. With `pad` (the resident engine) every block is the zero-padded
batch that the engine's former per-batch staging gave, values, dtype and
shape; without it (the streaming engine) the last block keeps only its
rows. The pinned path, its worker thread and its early stop are tested on
the card (tests/test_torch_cuda.py). Imports no JAX.
"""

import numpy as np
import pytest
import torch

from dldkd_tpu_torch import evaluate

CPU = torch.device("cpu")


def _padded_chunk(x: np.ndarray, start: int, n: int) -> torch.Tensor:
    """Rows [start, start + n) of x, zero-padded to n rows: the resident
    engine's batches before the pinned path."""
    block = torch.from_numpy(np.ascontiguousarray(x[start:start + n]))
    if block.shape[0] < n:
        block = torch.cat([block, block.new_zeros(
            (n - block.shape[0],) + tuple(block.shape[1:]))])
    return block


@pytest.mark.parametrize("pad", [True, False], ids=["padded", "trimmed"])
@pytest.mark.parametrize("n,block", [(30, 10), (37, 10), (7, 10)],
                         ids=["multiple", "partial_last", "single"])
def test_cpu_blocks_are_the_padded_or_trimmed_rows(n, block, pad):
    rng = np.random.RandomState(n)
    feats = rng.randn(n, 5, 3).astype(np.float32)
    mask = (rng.rand(n, 5) > 0.3).astype(np.float32)
    got = list(evaluate._blocks_on_device((feats, mask), block, CPU,
                                          pad=pad))
    assert [start for start, _ in got] == list(range(0, n, block))
    for start, staged in got:
        assert len(staged) == 2
        for t, a in zip(staged, (feats, mask)):
            want = (_padded_chunk(a, start, block) if pad
                    else torch.from_numpy(a[start:start + block]))
            assert t.device == CPU
            assert t.dtype == want.dtype and t.shape == want.shape
            assert torch.equal(t, want)
