"""Carry weights from the JAX parameter tree into the port's modules.

The JAX package's tree is {"params": {"inheritance": {...},
"exploration": {...}}} (Flax names); the port's modules carry the
reference PyTorch names. The mapping (the one documented at
dldkd_tpu/convert.py:8-20), with <p> = "" for inheritance and "exp_" for
exploration and <t> = query | visual:

  <t>_pos_embed/pos_embed             -> <p><t>_pos_embed.position_embeddings.weight
  <t>_pos_embed/norm/{scale,bias}     -> <p><t>_pos_embed.LayerNorm.{weight,bias}
  <t>_input_proj/input_norm/*         -> <p><t>_input_proj.LayerNorm.*
  <t>_input_proj/proj/{kernel,bias}   -> <p><t>_input_proj.net.1.{weight^T,bias}
  <t>_encoder/{query,key,value}/*     -> <p><t>_encoder.self.{query,key,value}.*
  <t>_encoder/out/*                   -> <p><t>_encoder.output.dense.*
  <t>_encoder/out_norm/*              -> <p><t>_encoder.output.LayerNorm.*
  modular_vector_mapping/kernel       -> <p>modular_vector_mapping.weight^T
  out_mapping_linear/{kernel,bias}    -> <p>out_mapping_linear.{weight^T,bias}

Flax Dense kernels are (in, out); torch Linear weights are (out, in).
The blocks the DLDKD towers do not use map the same way:
`feed_forward_state_from_jax` (FeedForward: intermediate/output/out_norm
-> intermediate.dense, output.dense, output.LayerNorm),
`transformer_block_state_from_jax` (attention/* as an encoder above, ffn/*
as FeedForward) and `rnn_state_from_jax` (RNNEncoder's flax cells ->
torch's stacked gate weights, models/rnn.py).
The optimizer state maps the same way: BertAdam's m and v are trees shaped
like the parameters (`opt_state_from_jax`, `opt_state_to_jax`), and so is
the JAX package's weight-decay mask (`wd_mask_from_jax`).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from dldkd_tpu_torch.models.dldkd import BRANCH_PREFIX


def _putter(out: Dict[str, np.ndarray], prefix: str = "", dtype=np.float32):
    def put(name, value, transpose=False):
        arr = np.asarray(value, dtype=dtype)
        out[prefix + name] = np.ascontiguousarray(arr.T if transpose else arr)
    return put


def _dense(put, name, p):
    put(f"{name}.weight", p["kernel"], transpose=True)
    put(f"{name}.bias", p["bias"])


def _norm(put, name, p):
    put(f"{name}.weight", p["scale"])
    put(f"{name}.bias", p["bias"])


def _attention(put, name, enc):
    for ours, theirs in (("query", "self.query"), ("key", "self.key"),
                         ("value", "self.value"), ("out", "output.dense")):
        _dense(put, f"{name}.{theirs}", enc[ours])
    _norm(put, f"{name}.output.LayerNorm", enc["out_norm"])


def _feed_forward(put, tree):
    _dense(put, "intermediate.dense", tree["intermediate"])
    _dense(put, "output.dense", tree["output"])
    _norm(put, "output.LayerNorm", tree["out_norm"])


def _branch_state(tree: Mapping, prefix: str, dtype=np.float32
                  ) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    put = _putter(out, prefix, dtype)
    for t in ("query", "visual"):
        pe = tree[f"{t}_pos_embed"]
        put(f"{t}_pos_embed.position_embeddings.weight", pe["pos_embed"])
        _norm(put, f"{t}_pos_embed.LayerNorm", pe["norm"])
        ip = tree[f"{t}_input_proj"]
        _norm(put, f"{t}_input_proj.LayerNorm", ip["input_norm"])
        _dense(put, f"{t}_input_proj.net.1", ip["proj"])
        _attention(put, f"{t}_encoder", tree[f"{t}_encoder"])
    put("modular_vector_mapping.weight",
        tree["modular_vector_mapping"]["kernel"], transpose=True)
    _dense(put, "out_mapping_linear", tree["out_mapping_linear"])
    return out


def _tensors(arrays: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(v) for k, v in arrays.items()}


def feed_forward_state_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX FeedForward's parameters ({"intermediate", "output",
    "out_norm"}, numpy leaves) -> components.FeedForward's state_dict."""
    out: Dict[str, np.ndarray] = {}
    _feed_forward(_putter(out), tree)
    return _tensors(out)


def transformer_block_state_from_jax(tree: Mapping
                                     ) -> Dict[str, torch.Tensor]:
    """A JAX TransformerBlock's parameters ({"attention"?, "ffn"}) ->
    components.TransformerBlock's state_dict (attention.* and the
    feed-forward names)."""
    out: Dict[str, np.ndarray] = {}
    put = _putter(out)
    if "attention" in tree:
        _attention(put, "attention", tree["attention"])
    _feed_forward(put, tree["ffn"])
    return _tensors(out)


# each flax cell's gates in torch's order, and which side has a bias
_RNN_GATES = {"lstm": (("ii", "if", "ig", "io"), ("hi", "hf", "hg", "ho")),
              "gru": (("ir", "iz", "in"), ("hr", "hz", "hn")),
              "rnn": (("i",), ("h",))}


def rnn_state_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX RNNEncoder's parameters ({"l<k>_fwd", "l<k>_bwd"?: cell
    params}) -> rnn.RNNEncoder's state_dict: each gate's kernel stacked
    in torch's gate order; a side flax gives no bias gets zeros there
    (see models/rnn.py)."""
    cell0 = tree["l0_fwd"]
    kind = "lstm" if "ii" in cell0 else "gru" if "ir" in cell0 else "rnn"
    out: Dict[str, np.ndarray] = {}
    for name, cell in tree.items():
        layer, direction = name[1:].split("_")
        put = _putter(out, f"layers.{layer}.")
        sfx = "_l0" + ("_reverse" if direction == "bwd" else "")
        for side, gates in zip(("ih", "hh"), _RNN_GATES[kind]):
            put(f"weight_{side}{sfx}", np.concatenate(
                [cell[g]["kernel"] for g in gates], axis=1), transpose=True)
            put(f"bias_{side}{sfx}", np.concatenate(
                [np.asarray(cell[g]["bias"]) if "bias" in cell[g]
                 else np.zeros(np.shape(cell[g]["kernel"])[1], np.float32)
                 for g in gates]))
    return _tensors(out)


def _named_arrays(params: Mapping, dtype=np.float32
                  ) -> Dict[str, np.ndarray]:
    tree = params["params"]
    unknown = set(tree) - set(BRANCH_PREFIX)
    if unknown:
        raise KeyError(f"unexpected branches in the parameter tree: "
                       f"{sorted(unknown)}")
    out: Dict[str, np.ndarray] = {}
    for branch, prefix in BRANCH_PREFIX.items():
        if branch in tree:
            out.update(_branch_state(tree[branch], prefix, dtype))
    return out


def state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves) -> the port's state_dict."""
    return _tensors(_named_arrays(params))


def wd_mask_from_jax(mask: Mapping) -> Dict[str, bool]:
    """The JAX package's weight-decay mask (a params-shaped tree of bools,
    dldkd_tpu/optim/bert_adam.py:default_wd_mask) in the port's names."""
    return {k: bool(v) for k, v in _named_arrays(mask, np.bool_).items()}


def opt_state_from_jax(opt_state: Mapping) -> Dict[str, Any]:
    """BertAdamState {"step", "m", "v"} of a JAX checkpoint -> the port's
    `BertAdam.load_state_dict` form (m and v in the port's names)."""
    return {"step": int(np.asarray(opt_state["step"])),
            "m": state_dict_from_jax(opt_state["m"]),
            "v": state_dict_from_jax(opt_state["v"])}


def opt_state_to_jax(state: Mapping) -> Dict[str, Any]:
    """`BertAdam.state_dict()` -> the JAX package's BertAdamState tree
    {"step": int32 scalar, "m": params tree, "v": params tree}, numpy
    leaves."""
    return {"step": np.asarray(state["step"], np.int32),
            "m": params_from_state_dict(state["m"]),
            "v": params_from_state_dict(state["v"])}


def load_jax_params(model: torch.nn.Module, params: Mapping
                    ) -> torch.nn.Module:
    """Load a JAX parameter tree into the port's DLDKD (strict)."""
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model


def params_from_state_dict(state_dict: Mapping[str, Any]
                           ) -> Dict[str, Any]:
    """The port's state_dict -> a JAX parameter tree (numpy leaves), the
    inverse of state_dict_from_jax; used to write a checkpoint from the
    port's own weights."""
    sd = {k: np.ascontiguousarray(v.detach().cpu().numpy()
                                  if hasattr(v, "detach") else np.asarray(v))
          for k, v in state_dict.items()}
    tree: Dict[str, Any] = {}
    for branch, p in BRANCH_PREFIX.items():
        if f"{p}out_mapping_linear.weight" not in sd:
            continue

        def dense(name):
            return {"kernel": np.ascontiguousarray(sd[f"{p}{name}.weight"].T),
                    "bias": sd[f"{p}{name}.bias"]}

        def norm(name):
            return {"scale": sd[f"{p}{name}.weight"],
                    "bias": sd[f"{p}{name}.bias"]}

        b: Dict[str, Any] = {}
        for t in ("query", "visual"):
            b[f"{t}_pos_embed"] = {
                "pos_embed": sd[f"{p}{t}_pos_embed.position_embeddings.weight"],
                "norm": norm(f"{t}_pos_embed.LayerNorm")}
            b[f"{t}_input_proj"] = {
                "input_norm": norm(f"{t}_input_proj.LayerNorm"),
                "proj": dense(f"{t}_input_proj.net.1")}
            b[f"{t}_encoder"] = {
                "query": dense(f"{t}_encoder.self.query"),
                "key": dense(f"{t}_encoder.self.key"),
                "value": dense(f"{t}_encoder.self.value"),
                "out": dense(f"{t}_encoder.output.dense"),
                "out_norm": norm(f"{t}_encoder.output.LayerNorm")}
        b["modular_vector_mapping"] = {"kernel": np.ascontiguousarray(
            sd[f"{p}modular_vector_mapping.weight"].T)}
        b["out_mapping_linear"] = dense("out_mapping_linear")
        tree[branch] = b
    return {"params": tree}


# ------------------------------------------------------------------ CLIP
# transformers' Flax CLIP tree (flax_model.msgpack) <-> models/clip.py's
# names (transformers' PyTorch CLIPModel names): Dense kernels (in, out)
# -> Linear weights (out, in); the patch convolution's kernel (kh, kw,
# cin, cout) -> Conv2d's (cout, cin, kh, kw); LayerNorm scale -> weight;
# Embed embedding -> weight.

def _clip_layer_names(tower: str, n_layers: int):
    for i in range(n_layers):
        base = f"{tower}.encoder.layers.{i}"
        for sub in ("self_attn.q_proj", "self_attn.k_proj",
                    "self_attn.v_proj", "self_attn.out_proj", "mlp.fc1",
                    "mlp.fc2"):
            yield f"{base}.{sub}", "dense"
        yield f"{base}.layer_norm1", "norm"
        yield f"{base}.layer_norm2", "norm"


def _clip_names(n_text: int, n_vision: int):
    """(module name, kind) of every CLIP parameter holder."""
    yield "text_model.embeddings.token_embedding", "embed"
    yield "text_model.embeddings.position_embedding", "embed"
    yield from _clip_layer_names("text_model", n_text)
    yield "text_model.final_layer_norm", "norm"
    yield "vision_model.embeddings.class_embedding", "leaf"
    yield "vision_model.embeddings.patch_embedding", "conv"
    yield "vision_model.embeddings.position_embedding", "embed"
    yield "vision_model.pre_layrnorm", "norm"
    yield from _clip_layer_names("vision_model", n_vision)
    yield "vision_model.post_layernorm", "norm"
    yield "text_projection", "dense_nobias"
    yield "visual_projection", "dense_nobias"
    yield "logit_scale", "leaf"


def _transpose(a: np.ndarray) -> np.ndarray:
    return a.T


# kind -> ((flax leaf, torch suffix, flax->torch, torch->flax), ...)
_CLIP_LEAVES = {
    "dense": (("kernel", "weight", _transpose, _transpose),
              ("bias", "bias", None, None)),
    "dense_nobias": (("kernel", "weight", _transpose, _transpose),),
    "norm": (("scale", "weight", None, None), ("bias", "bias", None, None)),
    "embed": (("embedding", "weight", None, None),),
    # (kh, kw, cin, cout) <-> (cout, cin, kh, kw)
    "conv": (("kernel", "weight", lambda a: a.transpose(3, 2, 0, 1),
              lambda a: a.transpose(2, 3, 1, 0)),),
}


def _clip_layer_count(keys, tower: str) -> int:
    prefix = f"{tower}.encoder.layers."
    return len({k[len(prefix):].split(".")[0] for k in keys
                if k.startswith(prefix)})


def clip_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """transformers' Flax CLIP parameter tree (numpy leaves, as
    `checkpoint.read_msgpack` reads flax_model.msgpack) -> models/clip.py's
    state_dict."""
    if "params" in params and "text_model" not in params:
        params = params["params"]
    n_text = len(params["text_model"]["encoder"]["layers"])
    n_vision = len(params["vision_model"]["encoder"]["layers"])
    out: Dict[str, np.ndarray] = {}
    for name, kind in _clip_names(n_text, n_vision):
        node = params
        for part in name.split("."):
            node = node[part]
        if kind == "leaf":
            out[name] = np.asarray(node, np.float32)
            continue
        for leaf, suffix, to_torch, _ in _CLIP_LEAVES[kind]:
            arr = np.asarray(node[leaf], np.float32)
            out[f"{name}.{suffix}"] = np.ascontiguousarray(
                to_torch(arr) if to_torch else arr)
    return _tensors(out)


def clip_params_to_flax(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """models/clip.py's state_dict -> transformers' Flax CLIP parameter
    tree (numpy leaves), the inverse of clip_state_dict_from_flax: what
    `FlaxCLIPModel.save_pretrained` writes to flax_model.msgpack."""
    # np.array, not ascontiguousarray: logit_scale stays 0-d
    sd = {k: np.array(v.detach().cpu().float().numpy()
                      if hasattr(v, "detach") else v, np.float32)
          for k, v in state_dict.items()}
    tree: Dict[str, Any] = {}
    for name, kind in _clip_names(_clip_layer_count(sd, "text_model"),
                                  _clip_layer_count(sd, "vision_model")):
        *parents, last = name.split(".")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        if kind == "leaf":
            node[last] = sd[name]
            continue
        leaves = node.setdefault(last, {})
        for leaf, suffix, _, to_flax in _CLIP_LEAVES[kind]:
            arr = sd[f"{name}.{suffix}"]
            leaves[leaf] = np.ascontiguousarray(to_flax(arr) if to_flax
                                                else arr)
    return tree
