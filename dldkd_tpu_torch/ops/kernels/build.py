"""Builds the port's CUDA sources at first use and binds them with ctypes.

Each `csrc/<name>.cu` compiles with nvcc for Hopper (`sm_90a`) into its own
shared library with a plain C interface, under `_build/` beside the
sources (listed in .gitignore). A library's file name carries a hash of its
source, of the shared headers (`csrc/*.cuh`) and of the flags, so an edited
source or header rebuilds and an unchanged one loads as it is, and one
directory can serve several checkouts and processes: `set_build_dir` points
the builds and loads at another directory (serving's `aot_cache_dir`, which
a fleet of replicas shares so that the offline index build fills it once). `build()`
starts one nvcc per missing library, all at once, and waits for them
together. A failed build raises with nvcc's output.

C entry points take pointers and the stream as `c_void_p` and return
`cudaGetLastError()` after the launch; `check()` turns a non-zero code into
an exception. Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "_build"
SOURCES = ("sim_max_mma", "tower", "tower_mma")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_BOUND: Dict[tuple, ctypes._CFuncPtr] = {}


def set_build_dir(path) -> None:
    """Build the libraries into, and load them from, `path` from now on
    (made if missing). Libraries already loaded from elsewhere are dropped
    from this process's table, so the next call of each kernel loads, or
    builds, its library under `path`."""
    global BUILD_DIR
    BUILD_DIR = Path(path).resolve()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    _LIBS.clear()
    _BOUND.clear()


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda or $PATH; raises if absent."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{key[:16]}.so"


def log_path(name: str) -> Path:
    """nvcc's output for the library (the -Xptxas -v register, spill and
    shared-memory summary)."""
    return library_path(name).with_suffix(".log")


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Build every named library that is missing, one nvcc each, all in
    parallel. Returns {name: library path}; raises if any build failed."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, proc in procs:
        text = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n"
                          f"{text}")
            tmp.unlink(missing_ok=True)
            continue
        log_path(name).write_text(text)
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The built library, building it first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LIBS[name] = lib
    return lib


def bind(name: str, symbol: str, n_ptrs: int, n_ints: int,
         n_floats: int = 0):
    """A C entry `int symbol(void* x n_ptrs, int x n_ints, float x n_floats,
    void* stream)` with its ctypes signature declared; declared once, since
    the towers call their entries on every launch."""
    key = (name, symbol, n_ptrs, n_ints, n_floats)
    fn = _BOUND.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _BOUND[key] = fn
    return fn


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
