"""Read and write the JAX package's checkpoint format without JAX.

`dldkd_tpu.checkpoint` writes `ckpt/model.ckpt` with Flax's msgpack
serialization of {"params", "opt_state", "epoch", "best_score", "rng"},
next to `ckpt/model_cfg.json`. In that encoding an ndarray is msgpack
ExtType 1 holding the msgpack triple (shape, dtype name, C-order bytes) and
a numpy scalar is ExtType 3 holding the same triple for a 0-d array (Flax
splits an array above 2**30 bytes into chunks; no array of this model comes
near that). Plain `msgpack` with an ext hook reads all of it. The writer
below emits the same format, so a checkpoint it writes also restores in
`dldkd_tpu`.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Tuple

import msgpack
import numpy as np

from dldkd_tpu_torch.config import ModelConfig

CKPT_NAME = "model.ckpt"
CFG_NAME = "model_cfg.json"

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def _array_from_bytes(data: bytes) -> np.ndarray:
    shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
    return np.frombuffer(buf, dtype=np.dtype(dtype_name.decode())
                         ).reshape(shape)


def _ext_hook(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _array_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _array_from_bytes(data)[()]
    raise ValueError(f"unsupported msgpack extension type {code}")


def _ext_default(obj):
    if isinstance(obj, np.ndarray):
        arr = obj   # tobytes("C") is C order whatever the layout; 0-d stays 0-d
        return msgpack.ExtType(_EXT_NDARRAY, msgpack.packb(
            (arr.shape, arr.dtype.name, arr.tobytes("C")), use_bin_type=True))
    if isinstance(obj, np.generic):
        arr = np.asarray(obj)
        return msgpack.ExtType(_EXT_NPSCALAR, msgpack.packb(
            (arr.shape, arr.dtype.name, arr.tobytes("C")), use_bin_type=True))
    raise TypeError(f"cannot serialize {type(obj)}")


def read_msgpack(path: str) -> Dict[str, Any]:
    """A tree written by Flax's `serialization.to_bytes` (or by
    `write_msgpack`), decoded with numpy leaves."""
    with open(path, "rb") as f:
        return msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)


def write_msgpack(path: str, tree: Mapping[str, Any]) -> None:
    """Write a tree of numpy leaves as Flax's `serialization.from_bytes`
    reads it; the file is replaced atomically."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(msgpack.packb(dict(tree), default=_ext_default,
                              strict_types=True, use_bin_type=True))
    os.replace(tmp, path)


def read_checkpoint(ckpt_dir: str) -> Dict[str, Any]:
    """The whole decoded checkpoint tree (numpy leaves)."""
    return read_msgpack(os.path.join(ckpt_dir, CKPT_NAME))


STATE_KEYS = ("params", "opt_state", "epoch", "best_score", "rng")


def restore_checkpoint(ckpt_dir: str) -> Dict[str, Any]:
    """The full training state {"params": {"params": ...}, "opt_state":
    {"step", "m", "v"}, "epoch", "best_score", "rng"} (numpy leaves) of a
    checkpoint written by either package, for --resume."""
    raw = read_checkpoint(ckpt_dir)
    missing = [k for k in STATE_KEYS if k not in raw]
    if missing:
        raise KeyError(f"{ckpt_dir}: not a full training state, missing "
                       f"{missing}")
    return raw


def restore_params_only(ckpt_dir: str) -> Tuple[Dict[str, Any], int]:
    """(params tree {"params": {...}} with numpy leaves, epoch), read the
    way dldkd_tpu.checkpoint.restore_params_only reads raw["params"] and
    raw["epoch"]."""
    raw = read_checkpoint(ckpt_dir)
    return raw["params"], int(raw.get("epoch", -1))


def load_model_cfg(ckpt_dir: str) -> ModelConfig:
    with open(os.path.join(ckpt_dir, CFG_NAME)) as f:
        return ModelConfig(**json.load(f))


def save_checkpoint(ckpt_dir: str, state: Mapping[str, Any],
                    model_cfg: ModelConfig) -> str:
    """Write `state` ({"params": {"params": {...}}, "epoch", ...}, numpy
    leaves) as model.ckpt plus model_cfg.json, in the JAX package's
    format. The file is replaced atomically."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, CKPT_NAME)
    write_msgpack(path, state)
    with open(os.path.join(ckpt_dir, CFG_NAME), "w") as f:
        json.dump({k: getattr(model_cfg, k)
                   for k in model_cfg.__dataclass_fields__}, f, indent=2)
    return path

