"""DL-DKD++ partially-relevant video retrieval in PyTorch, for one NVIDIA H100.

The port of `dldkd_tpu` (JAX/Flax/Pallas, the reference, which stays as it
is). It imports torch, numpy, h5py and msgpack, and nothing of JAX, Flax or
`dldkd_tpu`: what it needs from there it keeps as its own copy.

What is ported so far:
- the evaluation path of `scripts/do_test.sh` (`infer`, `evaluate`):
  checkpoint -> corpus and query towers -> masked cosine max-over-frames
  scoring -> rank -> R@K/SumR/mAP per branch and for the 0.7/0.3 fusion,
  and its int8 form (`--score_quant`: the video towers emit an int8 index,
  int8 scoring);
- serving on one GPU (`serving.Retriever`, `python -m
  dldkd_tpu_torch.serving`): exact search, two-stage search (int8
  shortlist, then exact rescoring by candidate gather or by a dense exact
  kernel) and int8-only search.
Every TPU kernel of the JAX package has a hand-written CUDA counterpart for
Hopper (`csrc/`: masked-cosine, int8 and exact-rescore scoring; the query
and video towers with the int8 epilogue), each with a plain PyTorch
version and a launch counter beside it (`ops/kernels/`). Not ported yet:
training, streaming eval, the raw serving store and index artifacts, and
multi-GPU (ROADMAP queue A).

Entry points take an explicit `device` and run on "cuda" unless the caller
asks for "cpu"; on the CPU every kernel wrapper uses its plain version.
"""

from __future__ import annotations

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
