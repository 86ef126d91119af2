"""On-disk serving-index artifacts: build once offline, load in every
serving replica (the port's copy of dldkd_tpu/utils/index_io.py).

The format is the JAX package's, so an artifact crosses between the two
packages in either direction: one directory per index, `meta.json` (format
version, store mode, logical dtypes, video ids, model-config repr, params
fingerprint) plus one `.npy` per array; bf16 arrays are stored as uint16
bit patterns and viewed back as bf16 on load (through torch: the card's
machine has neither `ml_dtypes` nor JAX). The params fingerprint binds the
index to the weights that encoded it; it is computed on the JAX form of the
port's weights (`convert.params_from_state_dict`), leaf for leaf as
`jax.tree.leaves` walks that tree, so both packages give the same digest
for the same weights. `publish_dir` swaps a fully written staging directory
into place, so a reader never sees new arrays beside an old meta.json.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Dict, Iterator, Mapping

import numpy as np
import torch

INDEX_FORMAT_VERSION = 2  # v2: q8 artifacts store canonical (Nv, L_p, D)
                          # rows + mask (device-count-independent)
META_NAME = "meta.json"


def _tree_leaves(tree) -> Iterator[Any]:
    """The leaves of a nested dict in `jax.tree.leaves` order: keys
    sorted, depth first."""
    if isinstance(tree, Mapping):
        for key in sorted(tree):
            yield from _tree_leaves(tree[key])
    else:
        yield tree


def params_fingerprint(model: torch.nn.Module) -> str:
    """Content hash of every parameter (shape, dtype, bytes) of the port's
    model in its JAX form, the JAX package's digest for the same weights."""
    from dldkd_tpu_torch.convert import params_from_state_dict

    h = hashlib.sha256()
    for leaf in _tree_leaves(params_from_state_dict(model.state_dict())):
        arr = np.asarray(leaf)
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    return h.hexdigest()[:24]


def save_array(dirpath: str, name: str, arr, manifest: Dict[str, str]
               ) -> None:
    """np.save one array (a numpy array or a tensor on any device); bf16
    stored as uint16 bit patterns, the logical dtype recorded in the
    manifest."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            x, logical = t.view(torch.int16).numpy().view(np.uint16), \
                "bfloat16"
        else:
            x = t.numpy()
            logical = str(x.dtype)
    else:
        x = np.asarray(arr)
        logical = str(x.dtype)
    np.save(os.path.join(dirpath, name + ".npy"), x)
    manifest[name] = logical


def load_array(dirpath: str, name: str, logical: str) -> torch.Tensor:
    """One array of an artifact as a CPU tensor in its logical dtype."""
    x = torch.from_numpy(np.load(os.path.join(dirpath, name + ".npy")))
    if logical == "bfloat16":
        x = x.view(torch.bfloat16)
    return x


def write_meta(dirpath: str, meta: Dict[str, Any]) -> None:
    meta = dict(meta, format=INDEX_FORMAT_VERSION)
    tmp = os.path.join(dirpath, META_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(dirpath, META_NAME))  # atomic publish


def publish_dir(staging: str, dst: str) -> None:
    """Swap a fully written staging directory into place as the artifact:
    every observable state is a whole artifact (old or new), never new
    arrays under the old meta.json; while dst is briefly absent a load
    fails cleanly."""
    old = dst + ".old"
    shutil.rmtree(old, ignore_errors=True)
    if os.path.isdir(dst):
        os.rename(dst, old)
    os.rename(staging, dst)
    shutil.rmtree(old, ignore_errors=True)


def read_meta(dirpath: str) -> Dict[str, Any]:
    with open(os.path.join(dirpath, META_NAME)) as f:
        meta = json.load(f)
    if meta.get("format") != INDEX_FORMAT_VERSION:
        raise ValueError(
            f"index format {meta.get('format')} != "
            f"{INDEX_FORMAT_VERSION} (rebuild the index)")
    return meta
