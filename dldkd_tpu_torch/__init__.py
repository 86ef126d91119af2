"""DL-DKD++ partially-relevant video retrieval in PyTorch, for one NVIDIA H100.

The port of `dldkd_tpu` (JAX/Flax/Pallas, the reference, which stays as it
is). It imports torch, numpy, h5py and msgpack, and nothing of JAX, Flax or
`dldkd_tpu`: what it needs from there it keeps as its own copy.

What is ported so far:
- training (`train.start_training`, `python -m dldkd_tpu_torch.train`):
  the packer and loader, the losses and objective, BertAdam and the
  schedules, the epoch loop with per-epoch validation on the eval engine
  below, the best-SumR checkpoint, early stop, full-state resume and the
  SIGTERM checkpoint, then test-split inference; the train step is plain
  PyTorch autograd (the JAX package's step calls no Pallas kernel), in
  f32 or with bf16 towers (`--dtype bfloat16`), the branches sequential
  or stacked (`--stacked_towers`, `models/stacked.py`); the train bench
  (`tools/train_bench.py`); the ablation losses, FeedForward /
  TransformerBlock, the RNN encoder and the sequence helpers;
- the evaluation path of `scripts/do_test.sh` (`infer`,
  `evaluate.run_retrieval_eval`): checkpoint -> corpus and query towers ->
  masked cosine max-over-frames scoring -> rank -> R@K/SumR/mAP per branch
  and for the 0.7/0.3 fusion, and its int8 form (`--score_quant`: the
  video towers emit an int8 index, int8 scoring);
- the corpus-streaming eval (`--corpus_stream_bsz`,
  `evaluate.stream_score_matrices`);
- serving (`serving.Retriever`, `python -m
  dldkd_tpu_torch.serving`): exact search, two-stage search (int8
  shortlist, then exact rescoring by candidate gather or by a dense exact
  kernel) and int8-only search, on the encoded or the raw store, and index
  artifacts in the JAX package's format (`save_index`, `load_index`);
- packing through the JAX package's C++ packer and pack cache
  (`data/native.py`, `data/cache.py`);
- teacher extraction (`python -m dldkd_tpu_torch.tools.extract_teacher`):
  a PyTorch CLIP (`models/clip.py`) read from a Flax model directory, the
  CLIP BPE tokenizer without `regex` (`tools/clip_tokenizer.py`), PIL's
  bicubic preprocessing on the card (`tools/clip_preprocess.py`), writing
  the teacher stores the trainer reads; `data/vocab.py`;
- the benches (`tools/`): the JAX package's stage, search, stream and
  cold-start benches on the port's kernels, and `python -m
  dldkd_tpu_torch.tools.bench`, one JSON line with the root bench.py's
  keys, their shapes from `tools/workload.py`;
- several GPUs (`parallel/`): data-parallel training with the global
  batch's losses under torchrun, the corpus-sharded eval (resident,
  streaming, int8) in the validation and `infer`, and corpus-sharded
  serving (`Retriever(mesh=...)`) on every store and route, in one
  process or under torchrun.
Every module and every TPU kernel of the JAX package has a counterpart
here; each kernel is hand-written CUDA for Hopper (`csrc/`: masked-cosine,
int8 and exact-rescore scoring; the query and video towers with the int8
epilogue and its transposed write), with a plain PyTorch version and a
launch counter beside it (`ops/kernels/`).

Entry points take an explicit `device` and run on "cuda" unless the caller
asks for "cpu"; on the CPU every kernel wrapper uses its plain version.
"""

from __future__ import annotations

import contextlib

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: "cuda" unless the caller says
    otherwise. Asking for CUDA without a GPU raises instead of quietly
    running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dldkd_tpu_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


# --matmul_precision (the JAX package's jax_default_matmul_precision) ->
# torch.set_float32_matmul_precision: "highest" keeps f32 products, "high"
# allows TF32, "default" allows bf16 passes, as "default" does on a TPU.
MATMUL_PRECISION = {"highest": "highest", "float32": "highest",
                    "high": "high", "tensorfloat32": "high",
                    "bfloat16_3x": "high", "default": "medium",
                    "bfloat16": "medium", "fastest": "medium"}


@contextlib.contextmanager
def float32_matmul_precision(setting: str):
    """Apply a --matmul_precision value to PyTorch's f32 products (plain
    PyTorch only: the f32 CUDA kernels run 3xTF32 at every setting) for
    the duration of the block, then restore the previous value."""
    if setting and setting not in MATMUL_PRECISION:
        raise ValueError(f"unknown matmul_precision {setting!r}; use one of "
                         f"{sorted(MATMUL_PRECISION)}")
    prev = torch.get_float32_matmul_precision()
    if setting:
        torch.set_float32_matmul_precision(MATMUL_PRECISION[setting])
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)
