"""ctypes binding of the native (C++) corpus packer (the port's copy of
dldkd_tpu/data/native.py).

`csrc/host/dldkd_native.cpp` is a byte-for-byte copy of the JAX package's
`native/dldkd_native.cpp`: a thread pool that preads each video's frame rows
from a BigFile's feature.bin, resamples them (twice for the training packer:
to the teacher's frame count, then to max_ctx_l) and L2-normalizes them.
g++ builds it on first use into the kernel build directory
(`ops/kernels/build.BUILD_DIR`, `csrc/_build/` by default), under a hash of
the source and the flags, never into `native/`. `pack_corpus_native`
returns None, and the packers in `data/ingest.py` take their numpy path,
when $DLDKD_NO_NATIVE is set (read at every call) or g++ or the library is
unavailable: the JAX package's rules for its host packer.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "csrc" / "host" / \
    "dldkd_native.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")

# calls of the native packer since the count was last set to 0
LAUNCHES = {"pack_corpus": 0}

_lock = threading.Lock()
_libs = {}   # library path -> CDLL, or None where the build failed

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")


def library_path() -> Path:
    from dldkd_tpu_torch.ops.kernels import build

    key = hashlib.sha256(SRC.read_bytes()
                         + " ".join(GXX_FLAGS).encode()).hexdigest()
    return build.BUILD_DIR / f"libdldkd_native-{key[:16]}.so"


def _build(out: Path) -> bool:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half
    return True


def load() -> Optional[ctypes.CDLL]:
    """The packer library, building it if needed; None if the native path
    is off ($DLDKD_NO_NATIVE) or unavailable."""
    if os.environ.get("DLDKD_NO_NATIVE"):
        return None
    path = library_path()
    with _lock:
        if path in _libs:
            return _libs[path]
        lib = None
        if path.exists() or _build(path):
            try:
                lib = ctypes.CDLL(str(path))
            except OSError:
                lib = None
        if lib is not None:
            lib.pack_corpus.restype = ctypes.c_int
            lib.pack_corpus.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, _i64p, _i64p,
                ctypes.c_int64, _i64p, ctypes.c_int64, ctypes.c_int,
                ctypes.c_float, _f32p, _f32p, ctypes.c_int]
        _libs[path] = lib
        return lib


def pack_corpus_native(
    bin_path: str,
    dim: int,
    frame_indices: List[np.ndarray],   # per video: BigFile row indices
    align_len: Optional[np.ndarray],   # per video teacher length, or None
    max_ctx_l: int,
    l2norm: bool = True,
    eps: float = 1e-5,
    n_threads: int = 0,
) -> Optional[tuple]:
    """(feats (N, L, D), mask (N, L)) packed by the C++ thread pool, or None
    if the native library is off or unavailable."""
    lib = load()
    if lib is None:
        return None
    n = len(frame_indices)
    rows = np.concatenate(frame_indices).astype(np.int64) if n else \
        np.zeros(0, np.int64)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum([len(f) for f in frame_indices], out=offsets[1:])
    if align_len is None:
        align_len = np.zeros(n, np.int64)
    align_len = np.ascontiguousarray(align_len, np.int64)
    feats = np.zeros((n, max_ctx_l, dim), np.float32)
    mask = np.zeros((n, max_ctx_l), np.float32)
    rc = lib.pack_corpus(bin_path.encode(), dim, np.ascontiguousarray(rows),
                         np.ascontiguousarray(offsets), n, align_len,
                         max_ctx_l, int(l2norm), eps, feats, mask, n_threads)
    if rc != 0:
        raise IOError(f"native pack_corpus failed reading {bin_path}")
    LAUNCHES["pack_corpus"] += 1
    return feats, mask
