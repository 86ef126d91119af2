"""The PyTorch port stands alone: importing it, or `chip_smoke.py`, loads
nothing of JAX, Flax or the JAX package, nor transformers or regex; its
entry points run on CUDA unless told otherwise; `chip_smoke.py` refuses to
report without a GPU."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

import dldkd_tpu_torch
from dldkd_tpu_torch.ops.kernels import build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import dldkd_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dldkd_tpu_torch.__path__,
                                               "dldkd_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "dldkd_tpu",
                                       "transformers", "regex"))
print(len(names), leaked)
"""


def _clean_env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = env.get("CUDA_VISIBLE_DEVICES", "")
    return env


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    n_modules, leaked = out.stdout.split(" ", 1)
    assert int(n_modules) >= 17
    assert leaked.strip() == "[]"


@pytest.mark.parametrize("module", ["dldkd_tpu_torch.serving",
                                    "dldkd_tpu_torch.infer",
                                    "dldkd_tpu_torch.train",
                                    "dldkd_tpu_torch.utils.index_io",
                                    "dldkd_tpu_torch.data.native",
                                    "dldkd_tpu_torch.data.cache",
                                    "dldkd_tpu_torch.models.stacked",
                                    "dldkd_tpu_torch.models.rnn",
                                    "dldkd_tpu_torch.utils.sequences",
                                    "dldkd_tpu_torch.tools.train_bench",
                                    "dldkd_tpu_torch.tools.extract_teacher",
                                    "dldkd_tpu_torch.tools.clip_tokenizer",
                                    "dldkd_tpu_torch.tools.clip_preprocess",
                                    "dldkd_tpu_torch.models.clip",
                                    "dldkd_tpu_torch.data.vocab",
                                    "dldkd_tpu_torch.tools.workload",
                                    "dldkd_tpu_torch.tools.stage_bench",
                                    "dldkd_tpu_torch.tools.search_bench",
                                    "dldkd_tpu_torch.tools.stream_bench",
                                    "dldkd_tpu_torch.tools.coldstart_bench",
                                    "dldkd_tpu_torch.tools.bench",
                                    "dldkd_tpu_torch.parallel",
                                    "dldkd_tpu_torch.parallel.eval_shard",
                                    "dldkd_tpu_torch.parallel.train_dp",
                                    "dldkd_tpu_torch.convert"])
def test_entry_points_import_no_jax(module):
    """The serving CLI, the eval CLI and the training CLI, the index
    artifacts, native packer and pack cache modules (whose JAX originals
    load no JAX either), the stacked towers, the RNN encoder, the sequence
    helpers, the train bench, the teacher extraction with its tokenizer,
    preprocessing and CLIP, and the benches with their workload (whose JAX
    originals read the root bench.py), each imported alone, load no JAX,
    Flax, JAX package, transformers or regex module; so does the
    multi-GPU package (`parallel/`), whose JAX original is built on
    jax.sharding; and so does the released-checkpoint converter, whose JAX
    original writes through Flax."""
    code = (f"import sys, {module}\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'dldkd_tpu', 'transformers', "
            "'regex')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_chip_smoke_fails_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_resolve_device():
    assert dldkd_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported"):
        dldkd_tpu_torch.resolve_device("meta")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: cuda resolves")
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dldkd_tpu_torch.resolve_device(dev)


def test_build_keys_libraries_by_source_and_flags(tmp_path, monkeypatch):
    """A library's name carries a hash of its source and the nvcc flags:
    an edited source gets a new library, an unchanged one keeps its own."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", src)
    monkeypatch.setattr(build, "BUILD_DIR", src / "_build")
    first = build.library_path("k")
    assert first == build.library_path("k")
    assert first.parent == src / "_build" and first.name.startswith("libk-")
    (src / "k.cu").write_text("// two\n")
    assert build.library_path("k") != first
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.library_path("k") != first


def test_sources_are_the_kernels_of_the_path():
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").is_file()
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
