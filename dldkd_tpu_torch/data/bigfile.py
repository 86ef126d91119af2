"""BigFile: the reference's raw binary feature store, memmap-backed.

Format (reference utils/basic_utils.py:9-68): a directory with
  shape.txt    "N ndims"
  id.txt       whitespace-separated row names (ISO-8859-1)
  feature.bin  N x ndims float32 (or float16: BigFile16), row-major

The reference reads rows with per-row file seeks inside DataLoader workers
(basic_utils.py:38-58) — the hot path of its input pipeline. Here the file
is a single numpy memmap and batched gathers are one fancy-index, which is
what the one-time packing step (dldkd_tpu_torch.data.ingest) wants.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Sequence

import numpy as np


class BigFile:
    """Read-only memmap view over a BigFile directory."""

    def __init__(self, datadir: str, dtype=np.float32):
        with open(os.path.join(datadir, "shape.txt")) as f:
            self.nr_of_images, self.ndims = map(int, f.readline().split())
        with open(os.path.join(datadir, "id.txt"), "rb") as f:
            names = f.read().strip().split()
        self.names: List[str] = [str(n, encoding="ISO-8859-1") for n in names]
        if len(self.names) != self.nr_of_images:
            raise ValueError(
                f"id.txt has {len(self.names)} names, shape.txt says "
                f"{self.nr_of_images}")
        self.name2index = {n: i for i, n in enumerate(self.names)}
        # the native packer (data/native.py) preads float32 rows from here
        self.bin_path = os.path.join(datadir, "feature.bin")
        self.dtype = np.dtype(dtype)
        self._mm = np.memmap(self.bin_path, dtype=self.dtype, mode="r",
                             shape=(self.nr_of_images, self.ndims))

    def read(self, names: Iterable[str]) -> np.ndarray:
        """Gather rows by name, in the order given. KeyError on unknown."""
        idx = np.fromiter((self.name2index[n] for n in names), dtype=np.int64)
        return np.asarray(self._mm[idx], dtype=np.float32)


class BigFile16(BigFile):
    """float16 variant (reference utils/basic_utils.py:70-129); packed by
    the numpy path."""

    def __init__(self, datadir: str):
        super().__init__(datadir, dtype=np.float16)


class BigFileWriter:
    """Write a BigFile directory (used by the synthetic dataset fixture)."""

    def __init__(self, datadir: str, ndims: int):
        os.makedirs(datadir, exist_ok=True)
        self.datadir = datadir
        self.ndims = ndims
        self.names: List[str] = []
        self._bin = open(os.path.join(datadir, "feature.bin"), "wb")

    def write_rows(self, names: Sequence[str], rows: np.ndarray) -> None:
        """Append len(names) rows (an (n, ndims) array) at once."""
        arr = np.ascontiguousarray(rows, dtype=np.float32)
        if arr.shape != (len(names), self.ndims):
            raise ValueError(f"expected ({len(names)}, {self.ndims}), got "
                             f"{arr.shape}")
        arr.tofile(self._bin)
        self.names.extend(names)

    def close(self) -> None:
        self._bin.close()
        with open(os.path.join(self.datadir, "shape.txt"), "w") as f:
            f.write(f"{len(self.names)} {self.ndims}\n")
        with open(os.path.join(self.datadir, "id.txt"), "w",
                  encoding="ISO-8859-1") as f:
            f.write(" ".join(self.names))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
