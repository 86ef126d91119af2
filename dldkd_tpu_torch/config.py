"""Typed configuration with the reference's public flag surface (the
PyTorch port's own copy of `dldkd_tpu/config.py`, kept in step with it so
an `opt.json` written by either package restores in the other).

Mirrors the argparse surface of the reference (`method/config.py:8-167` in
HuiGuanLab/DL-DKD): same flag names and defaults so `do_tvr.sh`-style
invocations keep working, same `opt.json` save/restore contract
(`method/config.py:109-138`) so eval always reproduces training-time
hyperparameters.

Unlike the reference, configuration is a frozen dataclass split into
semantically-typed sub-configs, and parsing has no hidden side effects beyond
results-dir creation + provenance dump (which live in `finalize()`).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass(frozen=True)
class ModelConfig:
    """Static architecture hyperparameters (trace-time constants).
    Frozen (hashable) so it can key caches and be shared freely.

    Reference: the `model_config` EDict built at `method/train.py:300-314`,
    plus `label_style`/`double_branch` which the reference reads off `opt`
    (and, in the case of `label_style`, forgets to thread into the config —
    a shipped bug we fix here; see reference `method/model.py:138`).
    """

    visual_input_size: int = 1024
    query_input_size: int = 1024
    inheritance_hidden: int = 384
    exploration_hidden: int = 384
    max_ctx_l: int = 128
    max_desc_l: int = 30
    input_drop: float = 0.1
    drop: float = 0.1
    n_heads: int = 4
    initializer_range: float = 0.02
    margin: float = 0.2
    use_hard_negative: bool = False
    hard_pool_size: int = 20
    double_branch: bool = False
    label_style: str = "hard"  # 'hard' (ICCV) or 'soft' (++ journal)
    # numerics
    dtype: str = "float32"  # compute dtype for the towers ('float32'|'bfloat16')
    # f32 matmul precision: 'highest' reproduces the reference bit-for-bit
    # class numerics; 'default' lets the MXU run bf16 passes (faster).
    # This JAX build's default is bf16-grade even on CPU, so parity work
    # must pin 'highest'. The port maps it onto
    # torch.set_float32_matmul_precision (dldkd_tpu_torch.MATMUL_PRECISION).
    matmul_precision: str = "highest"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TrainConfig:
    """Optimization + schedule hyperparameters (frozen, hashable)."""

    lr: float = 2.5e-4
    lr_warmup_proportion: float = 0.01
    wd: float = 0.01
    n_epoch: int = 120
    max_es_cnt: int = 10
    bsz: int = 128
    grad_clip: float = -1.0
    hard_negative_start_epoch: int = 0
    hard_pool_size: int = 20
    seed: int = 9527
    # distillation weight decay (reference method/train.py:73-82)
    distill_loss_decay: Optional[str] = None  # exp|sigmoid|linear|None
    exponential_k: float = 0.95
    linear_k: float = -0.01
    linear_b: float = 1.0
    sigmoid_k: float = 800.0
    selfDistil_sigmoid_k: float = 800.0
    # loss weights (reference method/config.py:94-97)
    kl_intra_weight: float = 0.1
    inher_nce_weight: float = 0.04
    explore_nce_weight: float = 0.04
    # soft-label knobs (reference method/config.py:99-103)
    alpha: float = 0.8
    belta: float = 0.8
    alpha_decay: Optional[str] = "sigmoid"
    belta_decay: Optional[str] = "sigmoid"
    # run both branches' towers as one stacked (2, ...) computation in the
    # train step (models/stacked.py): half the tower launches, the same
    # per-branch math; the dropout stream differs from the sequential
    # forward's, so parity runs keep it off.
    stacked_towers: bool = False
    # TPU-native extension: PRNG implementation for the TRAINING streams
    # (dropout masks, triplet negative sampling). 'rbg' uses the TPU
    # hardware RNG instead of threefry bit generation on the VPU:
    # measured 10.0 -> 8.4 ms (1.18x) on the stacked-bf16 bsz-128 step,
    # interleaved A/B (BENCHMARKS.md; tools/train_bench.py has the
    # per-stage breakdown). Same distributions, different streams (like
    # stacked_towers), so the f32 PARITY config keeps the jax default.
    # Param init always uses threefry: the knob changes only the per-step
    # streams, never the starting weights.
    rng_impl: str = "threefry2x32"


@dataclass
class DataConfig:
    """Dataset layout + loading knobs (reference method/config.py:32-36,59-68)."""

    root_path: str = ""
    collection: str = "activitynet"
    visual_feature: str = "i3d"
    q_feat_size: int = 1024
    max_desc_l: int = 30
    max_ctx_l: int = 128
    num_workers: int = 8
    teacher: str = "clip"
    student: str = "i3d"
    # query-axis padding bucket for static jit shapes (TPU addition; the
    # reference pads to per-batch max, we pad the flattened caption axis up
    # to a multiple of this).
    query_pad_multiple: int = 64
    # content-keyed packed-dataset cache (data/cache.py): second launches
    # mmap the packed arrays instead of re-walking BigFile/HDF5
    pack_cache: bool = True


@dataclass
class EvalConfig:
    eval_query_bsz: int = 50
    eval_context_bsz: int = 200
    eval_split_name: str = "val"
    eval_id: str = "test"
    model_dir: str = ""
    # TPU-native extension: int8-quantized retrieval scoring (2x MXU rate,
    # ~2.7e-3 absolute score error; see ops.similarity.clip_scores_maxpool)
    score_quant: bool = False
    # TPU-native extension: corpus-streaming eval for corpora beyond HBM
    # (videos per streamed block; 0 = AUTO — resident when the estimated
    # footprint fits the device budget, streaming otherwise; -1 = force
    # corpus-resident). See evaluate.run_retrieval_eval / auto_stream_block.
    corpus_stream_bsz: int = 0


@dataclass
class Config:
    """Top-level run configuration. Field names inside sub-configs match the
    reference flag names 1:1 (`method/config.py`), so `to_flat_dict()`
    round-trips through opt.json the same way the reference does."""

    model_name: str = "DLDKD"
    exp_id: str = "debug"
    dset_name: str = ""
    results_root: str = "results"
    debug: bool = False
    device: int = 0
    device_ids: List[int] = field(default_factory=lambda: [0])
    eval_untrained: bool = False
    train_path: Optional[str] = None
    eval_path: Optional[str] = None
    max_position_embeddings: int = 300
    no_norm_vfeat: bool = False
    no_norm_tfeat: bool = False

    # TPU-native extensions (no reference equivalent)
    resume: str = ""           # ckpt dir to restore full training state from
    debug_nans: bool = False   # jax_debug_nans (detect_anomaly equivalent)
    profile_dir: str = ""      # torch.profiler trace.json + counts.json here
    profile_steps: int = 8     # steps to trace
    # port-only: the torch device the entry points run on ('cuda' | 'cpu')
    torch_device: str = "cuda"

    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)

    # derived at finalize()
    results_dir: str = ""
    ckpt_dir: str = ""
    train_log_filepath: str = ""
    eval_log_filepath: str = ""
    tensorboard_log_dir: str = ""

    # ------------------------------------------------------------------ #
    # flat dict round-trip (opt.json compatibility)
    # ------------------------------------------------------------------ #

    _FLAT_ALIASES = {
        # reference flag name -> (section, field)
        "label_style": ("model", "label_style"),
        "double_branch": ("model", "double_branch"),
        "inheritance_hidden": ("model", "inheritance_hidden"),
        "exploration_hidden": ("model", "exploration_hidden"),
        "n_heads": ("model", "n_heads"),
        "input_drop": ("model", "input_drop"),
        "drop": ("model", "drop"),
        "initializer_range": ("model", "initializer_range"),
        "margin": ("model", "margin"),
        "max_ctx_l": ("model", "max_ctx_l"),
        "max_desc_l": ("model", "max_desc_l"),
        "dtype": ("model", "dtype"),
        "matmul_precision": ("model", "matmul_precision"),
        "lr": ("train", "lr"),
        "lr_warmup_proportion": ("train", "lr_warmup_proportion"),
        "wd": ("train", "wd"),
        "n_epoch": ("train", "n_epoch"),
        "max_es_cnt": ("train", "max_es_cnt"),
        "bsz": ("train", "bsz"),
        "grad_clip": ("train", "grad_clip"),
        "hard_negative_start_epoch": ("train", "hard_negative_start_epoch"),
        "hard_pool_size": ("train", "hard_pool_size"),
        "seed": ("train", "seed"),
        "distill_loss_decay": ("train", "distill_loss_decay"),
        "exponential_k": ("train", "exponential_k"),
        "linear_k": ("train", "linear_k"),
        "linear_b": ("train", "linear_b"),
        "sigmoid_k": ("train", "sigmoid_k"),
        "selfDistil_sigmoid_k": ("train", "selfDistil_sigmoid_k"),
        "kl_intra_weight": ("train", "kl_intra_weight"),
        "inher_nce_weight": ("train", "inher_nce_weight"),
        "explore_nce_weight": ("train", "explore_nce_weight"),
        "alpha": ("train", "alpha"),
        "belta": ("train", "belta"),
        "alpha_decay": ("train", "alpha_decay"),
        "belta_decay": ("train", "belta_decay"),
        "stacked_towers": ("train", "stacked_towers"),
        "rng_impl": ("train", "rng_impl"),
        "root_path": ("data", "root_path"),
        "collection": ("data", "collection"),
        "visual_feature": ("data", "visual_feature"),
        "q_feat_size": ("data", "q_feat_size"),
        "num_workers": ("data", "num_workers"),
        "teacher": ("data", "teacher"),
        "student": ("data", "student"),
        "query_pad_multiple": ("data", "query_pad_multiple"),
        "pack_cache": ("data", "pack_cache"),
        "eval_query_bsz": ("eval", "eval_query_bsz"),
        "eval_context_bsz": ("eval", "eval_context_bsz"),
        "eval_split_name": ("eval", "eval_split_name"),
        "eval_id": ("eval", "eval_id"),
        "model_dir": ("eval", "model_dir"),
        "score_quant": ("eval", "score_quant"),
        "corpus_stream_bsz": ("eval", "corpus_stream_bsz"),
    }

    def to_flat_dict(self) -> Dict[str, Any]:
        """Flatten to the reference's opt.json schema (one flat namespace)."""
        out: Dict[str, Any] = {}
        for f in dataclasses.fields(self):
            if f.name in ("model", "train", "data", "eval"):
                continue
            out[f.name] = getattr(self, f.name)
        for flag, (section, fname) in self._FLAT_ALIASES.items():
            out[flag] = getattr(getattr(self, section), fname)
        # names the reference also saves
        out["visual_feat_dim"] = self.model.visual_input_size
        return out

    @classmethod
    def from_flat_dict(cls, d: Dict[str, Any]) -> "Config":
        cfg = cls()
        sections = {s: {} for s in ("model", "train", "data", "eval")}
        top: Dict[str, Any] = {}
        top_fields = {f.name for f in dataclasses.fields(cls)}
        for k, v in d.items():
            if k in cls._FLAT_ALIASES:
                section, fname = cls._FLAT_ALIASES[k]
                sections[section][fname] = v
            elif k == "visual_feat_dim":
                sections["model"]["visual_input_size"] = v
            elif k in top_fields and k not in ("model", "train", "data", "eval"):
                top[k] = v
        # keep q_feat_size -> model.query_input_size coupling
        if "q_feat_size" in d:
            sections["model"]["query_input_size"] = d["q_feat_size"]
        # coupled duplicates across sections
        for key in ("max_ctx_l", "max_desc_l"):
            if key in d:
                sections["data"][key] = d[key]
        if "hard_pool_size" in d:
            sections["model"]["hard_pool_size"] = d["hard_pool_size"]
        cfg = dataclasses.replace(
            cfg,
            model=dataclasses.replace(cfg.model, **sections["model"]),
            train=dataclasses.replace(cfg.train, **sections["train"]),
            data=dataclasses.replace(cfg.data, **sections["data"]),
            eval=dataclasses.replace(cfg.eval, **sections["eval"]),
            **top,
        )
        return cfg

    # ------------------------------------------------------------------ #
    # run-dir provenance
    # ------------------------------------------------------------------ #

    def finalize(self, make_dirs: bool = True) -> "Config":
        """Derive results paths + dump opt.json (reference method/config.py:119-167)."""
        dset = self.dset_name or self.data.collection
        results_root = self.results_root
        if self.debug:
            results_root = os.path.join(os.path.dirname(results_root) or ".", "debug_results")
        results_dir = os.path.join(
            results_root, dset,
            "-".join([dset, self.exp_id, time.strftime("%Y_%m_%d_%H_%M_%S")]),
        )
        cfg = dataclasses.replace(
            self,
            dset_name=dset,
            results_dir=results_dir,
            ckpt_dir=os.path.join(results_dir, "ckpt"),
            train_log_filepath=os.path.join(results_dir, "train.log.txt"),
            eval_log_filepath=os.path.join(results_dir, "eval.log.txt"),
            tensorboard_log_dir=os.path.join(results_dir, "tensorboard_log"),
        )
        if make_dirs:
            os.makedirs(cfg.results_dir, exist_ok=True)
            cfg.save(os.path.join(cfg.results_dir, "opt.json"))
        return cfg

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_flat_dict(), f, indent=2, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_flat_dict(json.load(f))


# ---------------------------------------------------------------------- #
# argparse surface
# ---------------------------------------------------------------------- #

# flags restored from the saved opt.json during eval EXCEPT this allowlist
# (reference method/config.py:134-138)
_TEST_OVERRIDE_ALLOWLIST = {
    "results_root", "num_workers", "debug", "eval_split_name", "eval_path",
    "eval_query_bsz", "eval_context_bsz", "root_path", "model_dir",
    "score_quant",  # an eval-time speed knob, never a training property
    "corpus_stream_bsz",  # eval-time memory knob, never a training property
    "torch_device",  # where the port runs; never a training property
    "profile_dir",  # where the eval's trace goes; never a training property
}


def build_parser(test: bool = False) -> argparse.ArgumentParser:
    """The reference's flag surface (method/config.py:20-104), 1:1 names."""
    p = argparse.ArgumentParser()
    p.add_argument("--dset_name", type=str, default=None)
    p.add_argument("--eval_split_name", type=str, default="val")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--results_root", type=str, default="results")
    p.add_argument("--exp_id", type=str, default="debug")
    p.add_argument("--seed", type=int, default=9527)
    p.add_argument("--device", type=int, default=0)
    p.add_argument("--device_ids", type=int, nargs="+", default=[0])
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--no_core_driver", action="store_true")
    p.add_argument("--no_pin_memory", action="store_true")
    p.add_argument("--lr", type=float, default=2.5e-4)
    p.add_argument("--lr_warmup_proportion", type=float, default=0.01)
    p.add_argument("--wd", type=float, default=0.01)
    p.add_argument("--n_epoch", type=int, default=120)
    p.add_argument("--max_es_cnt", type=int, default=10)
    p.add_argument("--bsz", type=int, default=128)
    p.add_argument("--eval_query_bsz", type=int, default=50)
    p.add_argument("--eval_context_bsz", type=int, default=200)
    p.add_argument("--eval_untrained", action="store_true")
    p.add_argument("--grad_clip", type=float, default=-1)
    p.add_argument("--margin", type=float, default=0.2)
    p.add_argument("--hard_negative_start_epoch", type=int, default=0)
    p.add_argument("--hard_pool_size", type=int, default=20)
    p.add_argument("--max_desc_l", type=int, default=30)
    p.add_argument("--max_ctx_l", type=int, default=128)
    p.add_argument("--train_path", type=str, default=None)
    p.add_argument("--eval_path", type=str, default=None)
    p.add_argument("--q_feat_size", type=int, default=1024)
    p.add_argument("--no_norm_vfeat", action="store_true")
    p.add_argument("--no_norm_tfeat", action="store_true")
    p.add_argument("--vid_feat_size", type=int, default=None)
    p.add_argument("--max_position_embeddings", type=int, default=300)
    p.add_argument("--inheritance_hidden", type=int, default=384)
    p.add_argument("--exploration_hidden", type=int, default=384)
    p.add_argument("--n_heads", type=int, default=4)
    p.add_argument("--input_drop", type=float, default=0.1)
    p.add_argument("--drop", type=float, default=0.1)
    p.add_argument("--initializer_range", type=float, default=0.02)
    p.add_argument("--model_name", type=str, default="DLDKD")
    p.add_argument("--root_path", type=str, default="")
    p.add_argument("--visual_feature", type=str, default="i3d")
    p.add_argument("--collection", type=str, default="activitynet")
    p.add_argument("--linear_k", type=float, default=-0.01)
    p.add_argument("--sigmoid_k", type=float, default=800)
    p.add_argument("--selfDistil_sigmoid_k", type=float, default=800)
    p.add_argument("--linear_b", type=float, default=1)
    p.add_argument("--exponential_k", type=float, default=0.95)
    p.add_argument("--distill_loss_decay", type=str, default=None)
    p.add_argument("--double_branch", action="store_true")
    p.add_argument("--teacher", type=str, default="clip")
    p.add_argument("--student", type=str, default="i3d")
    p.add_argument("--kl_intra_weight", type=float, default=0.1)
    p.add_argument("--inher_nce_weight", type=float, default=0.04)
    p.add_argument("--explore_nce_weight", type=float, default=0.04)
    p.add_argument("--label_style", type=str, default="hard")
    p.add_argument("--alpha", type=float, default=0.8)
    p.add_argument("--belta", type=float, default=0.8)
    p.add_argument("--alpha_decay", type=str, default="sigmoid")
    p.add_argument("--belta_decay", type=str, default="sigmoid")
    # TPU-native extensions
    p.add_argument("--dtype", type=str, default="float32",
                   help="tower compute dtype: float32 or bfloat16. In "
                        "bfloat16 the towers' products and LayerNorm outputs "
                        "round to bf16 where the JAX package's flax modules "
                        "do; parameters, gradients, the optimizer and every "
                        "loss stay float32; validation and inference run "
                        "the bf16 CUDA kernels")
    p.add_argument("--matmul_precision", type=str, default="highest",
                   help="f32 matmul precision: highest (parity) | high | "
                        "default (fast). In the PyTorch port it sets "
                        "torch.set_float32_matmul_precision for training "
                        "and inference (highest -> 'highest', high -> "
                        "'high' (TF32), default -> 'medium' (bf16 "
                        "passes)); the f32 CUDA kernels (scoring, towers) "
                        "run 3xTF32 at every setting, at least what each "
                        "setting asks for")
    p.add_argument("--query_pad_multiple", type=int, default=64)
    p.add_argument("--no_pack_cache", action="store_true",
                   help="disable the content-keyed packed-dataset cache "
                        "(data/cache.py) and re-pack from BigFile/HDF5")
    p.add_argument("--resume", type=str, default="",
                   help="ckpt dir: restore params+optimizer+epoch+rng and "
                        "continue (the reference cannot resume, SURVEY S5.4)")
    p.add_argument("--debug_nans", action="store_true",
                   help="abort on NaN (torch detect_anomaly equivalent)")
    p.add_argument("--profile_dir", type=str, default="")
    p.add_argument("--profile_steps", type=int, default=8)
    p.add_argument("--stacked_towers", action="store_true",
                   help="train both branches' towers as one stacked "
                        "(2, ...) computation (models/stacked.py: batched "
                        "products on the two branches' stacked weights, "
                        "half the tower launches); needs --double_branch "
                        "with equal hidden sizes. Its dropout stream "
                        "differs from the sequential forward's: keep it "
                        "off for parity runs")
    p.add_argument("--rng_impl", choices=("threefry2x32", "rbg"),
                   default="threefry2x32",
                   help="PRNG for the training streams (dropout, negative "
                        "sampling): 'rbg' = TPU hardware RNG, ~1.2x the "
                        "bsz-128 step (same distributions, different "
                        "streams — keep the default for parity runs). "
                        "n/a in the PyTorch port, which accepts it and "
                        "draws every stream from one torch.Generator")
    p.add_argument("--score_quant", action="store_true",
                   help="int8-quantized retrieval scoring (2x MXU rate, "
                        "~2.7e-3 score error; rank-preserving on separated "
                        "data — serving speed knob, off for parity runs)")
    p.add_argument("--corpus_stream_bsz", type=int, default=0,
                   help="stream the eval corpus through the device in "
                        "blocks of this many videos (for corpora beyond "
                        "HBM); 0 = AUTO (resident when the estimated "
                        "footprint fits the device budget, streaming "
                        "otherwise); -1 = force corpus-resident")
    p.add_argument("--torch_device", choices=("cuda", "cpu"), default="cuda",
                   help="device the PyTorch port runs on; 'cuda' raises "
                        "when no GPU is present")
    if test:
        p.add_argument("--eval_id", type=str, default="test")
        p.add_argument("--model_dir", type=str, default="")
    return p


def _namespace_to_config(ns: argparse.Namespace) -> Config:
    d = vars(ns).copy()
    vid_feat_size = d.pop("vid_feat_size", None)
    d.pop("no_core_driver", None)
    d.pop("no_pin_memory", None)
    d["pack_cache"] = not d.pop("no_pack_cache", False)
    if vid_feat_size:
        d["visual_feat_dim"] = vid_feat_size
    # normalize 'None' strings on decay flags like the reference's asserts
    for k in ("distill_loss_decay", "alpha_decay", "belta_decay"):
        if d.get(k) == "None":
            d[k] = "None"  # keep literal; schedule layer treats it as identity
    return Config.from_flat_dict(d)


def parse_args(argv: Optional[List[str]] = None, test: bool = False,
               finalize: bool = True) -> Config:
    """Parse CLI flags into a Config.

    With test=True, restores the saved opt.json from --model_dir and
    overwrites everything except the allowlist, reproducing the reference's
    TestOptions semantics (method/config.py:130-138).
    """
    ns = build_parser(test=test).parse_args(argv)
    if test:
        model_dir = ns.model_dir
        if not os.path.isabs(model_dir) and not os.path.isdir(model_dir):
            model_dir = os.path.join("results", model_dir)
        with open(os.path.join(model_dir, "opt.json")) as f:
            saved = json.load(f)
        for k, v in saved.items():
            if k not in _TEST_OVERRIDE_ALLOWLIST and hasattr(ns, k):
                setattr(ns, k, v)
        ns.model_dir = model_dir
        cfg = _namespace_to_config(ns)
        cfg = dataclasses.replace(
            cfg,
            results_dir=model_dir,
            ckpt_dir=os.path.join(model_dir, "ckpt"),
            eval=dataclasses.replace(cfg.eval, model_dir=model_dir),
        )
        return cfg
    cfg = _namespace_to_config(ns)
    if ns.debug:
        # mirror the reference's debug side effects (method/config.py:125-129):
        # separate results root (in finalize), eval_query_bsz=100, workers=0
        cfg = dataclasses.replace(
            cfg, debug=True,
            eval=dataclasses.replace(cfg.eval, eval_query_bsz=100),
            data=dataclasses.replace(cfg.data, num_workers=0),
        )
    if finalize:
        cfg = cfg.finalize()
    return cfg
