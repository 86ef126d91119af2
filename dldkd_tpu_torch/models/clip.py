"""CLIP in PyTorch: the teacher of `tools/extract_teacher.py`.

Computes what transformers' `FlaxCLIPModel.get_text_features` and
`get_image_features` compute, which the JAX package's extraction tool
runs (dldkd_tpu/tools/extract_teacher.py:149-172), as plain PyTorch:
- each encoder layer is pre-LayerNorm attention then a quick-GELU MLP
  (x * sigmoid(1.702 x)), each with a residual; attention is Flax's
  explicit chain: q / sqrt(head_dim), q @ k^T, + mask bias (0 or the f32
  minimum), softmax, @ v;
- text: token + position embeddings, a causal mask combined with
  `attention_mask`, the encoder, `final_layer_norm`, then one position
  per row: the argmax of `input_ids` when `eos_token_id` is 2 (the legacy
  branch the openai checkpoints' config takes), else the first position
  holding `eos_token_id` (0 when none does); then `text_projection`;
- vision: NCHW pixels cut into patch_size x patch_size patches (Flax's
  stride-patch "VALID" convolution without bias, as one product),
  `class_embedding` prepended, position embeddings added,
  `pre_layrnorm`, the encoder, `post_layernorm` on token 0, then
  `visual_projection`.
Both projections have no bias and the features are not normalized.

The parameter names are transformers' PyTorch `CLIPModel` names.
`load_clip(model_dir)` reads the directory `FlaxCLIPModel.from_pretrained`
reads: `config.json` and `flax_model.msgpack` (through
`convert.clip_state_dict_from_flax`); `save_clip` writes one. Neither
needs transformers.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, fields
from typing import Any, Dict, Optional

import torch
from torch import nn

CONFIG_NAME = "config.json"
WEIGHTS_NAME = "flax_model.msgpack"


@dataclass(frozen=True)
class ClipTowerConfig:
    """One tower's config.json entries (`_TEXT_ONLY` / `_VISION_ONLY` are
    one tower's alone), with transformers' defaults for CLIPTextConfig and
    CLIPVisionConfig (the vision tower's own in `VISION_DEFAULTS`)."""
    hidden_size: int = 512
    intermediate_size: int = 2048
    num_hidden_layers: int = 12
    num_attention_heads: int = 8
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    vocab_size: int = 49408
    max_position_embeddings: int = 77
    eos_token_id: int = 49407
    image_size: int = 224
    patch_size: int = 32
    num_channels: int = 3

    @classmethod
    def from_dict(cls, d: Dict[str, Any], defaults: Dict[str, Any]
                  ) -> "ClipTowerConfig":
        names = {f.name for f in fields(cls)}
        merged = {**defaults, **{k: v for k, v in d.items() if k in names}}
        return cls(**merged)


_TEXT_ONLY = ("vocab_size", "max_position_embeddings", "eos_token_id")
_VISION_ONLY = ("image_size", "patch_size", "num_channels")
VISION_DEFAULTS = dict(hidden_size=768, intermediate_size=3072,
                       num_attention_heads=12)


@dataclass(frozen=True)
class ClipConfig:
    text: ClipTowerConfig
    vision: ClipTowerConfig
    projection_dim: int = 512

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ClipConfig":
        """config.json's content: `text_config` / `vision_config` hold only
        what differs from the defaults (older files also carry
        `*_config_dict`, which wins, as in transformers)."""
        def tower(key, defaults):
            return ClipTowerConfig.from_dict(
                {**(d.get(f"{key}_config") or {}),
                 **(d.get(f"{key}_config_dict") or {})}, defaults)
        return cls(text=tower("text", {}),
                   vision=tower("vision", VISION_DEFAULTS),
                   projection_dim=int(d.get("projection_dim", 512)))

    def to_dict(self) -> Dict[str, Any]:
        """config.json's content, every entry written out."""
        def tower(c, model_type, other):
            return {"model_type": model_type,
                    **{f.name: getattr(c, f.name) for f in fields(c)
                       if f.name not in other}}
        return {"architectures": ["CLIPModel"], "model_type": "clip",
                "projection_dim": self.projection_dim,
                "text_config": tower(self.text, "clip_text_model",
                                     _VISION_ONLY),
                "vision_config": tower(self.vision, "clip_vision_model",
                                       _TEXT_ONLY)}


def _quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class ClipAttention(nn.Module):
    def __init__(self, cfg: ClipTowerConfig):
        super().__init__()
        d = cfg.hidden_size
        if d % cfg.num_attention_heads:
            raise ValueError(f"hidden_size {d} is not a multiple of "
                             f"num_attention_heads {cfg.num_attention_heads}")
        self.n_heads = cfg.num_attention_heads
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor]
                ) -> torch.Tensor:
        b, length, d = x.shape
        hd = d // self.n_heads

        def heads(t):
            return t.reshape(b, length, self.n_heads, hd).transpose(1, 2)

        q = heads(self.q_proj(x)) / math.sqrt(hd)
        w = torch.matmul(q, heads(self.k_proj(x)).transpose(-1, -2))
        if bias is not None:
            w = w + bias
        out = torch.matmul(torch.softmax(w, dim=-1), heads(self.v_proj(x)))
        return self.out_proj(out.transpose(1, 2).reshape(b, length, d))


class ClipMLP(nn.Module):
    def __init__(self, cfg: ClipTowerConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        if cfg.hidden_act != "quick_gelu":
            raise ValueError(f"CLIP hidden_act {cfg.hidden_act!r}: only "
                             f"quick_gelu (CLIP's) is implemented")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(_quick_gelu(self.fc1(x)))


class ClipEncoderLayer(nn.Module):
    def __init__(self, cfg: ClipTowerConfig):
        super().__init__()
        self.self_attn = ClipAttention(cfg)
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.mlp = ClipMLP(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, x, bias):
        x = x + self.self_attn(self.layer_norm1(x), bias)
        return x + self.mlp(self.layer_norm2(x))


class ClipEncoder(nn.Module):
    def __init__(self, cfg: ClipTowerConfig):
        super().__init__()
        self.layers = nn.ModuleList(ClipEncoderLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers))

    def forward(self, x, bias=None):
        for layer in self.layers:
            x = layer(x, bias)
        return x


class ClipTextEmbeddings(nn.Module):
    def __init__(self, cfg: ClipTowerConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size)


class ClipTextTransformer(nn.Module):
    def __init__(self, cfg: ClipTowerConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = ClipTextEmbeddings(cfg)
        self.encoder = ClipEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                             cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        """(B, L) ids and mask -> (B, hidden) pooled states."""
        input_ids = input_ids.long()
        length = input_ids.shape[1]
        emb = self.embeddings
        x = (emb.token_embedding(input_ids)
             + emb.position_embedding.weight[:length])
        causal = torch.ones(length, length, dtype=torch.bool,
                            device=x.device).tril()
        keep = causal & (attention_mask > 0)[:, None, None, :]
        bias = torch.zeros(keep.shape, dtype=x.dtype, device=x.device
                           ).masked_fill_(~keep, torch.finfo(x.dtype).min)
        x = self.final_layer_norm(self.encoder(x, bias))
        if self.cfg.eos_token_id == 2:
            pos = input_ids.argmax(dim=-1)
        else:
            pos = (input_ids == self.cfg.eos_token_id).int().argmax(dim=-1)
        return x[torch.arange(x.shape[0], device=x.device), pos]


class ClipVisionEmbeddings(nn.Module):
    def __init__(self, cfg: ClipTowerConfig):
        super().__init__()
        d, p = cfg.hidden_size, cfg.patch_size
        self.patch_size = p
        self.class_embedding = nn.Parameter(torch.zeros(d))
        # torch's Conv2d layout (out, in, kh, kw), applied as one product
        self.patch_embedding = nn.Module()
        self.patch_embedding.weight = nn.Parameter(
            torch.zeros(d, cfg.num_channels, p, p))
        self.position_embedding = nn.Embedding(
            (cfg.image_size // p) ** 2 + 1, d)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        b, c, h, w = pixel_values.shape
        p = self.patch_size
        gh, gw = h // p, w // p
        patches = (pixel_values[:, :, :gh * p, :gw * p]
                   .reshape(b, c, gh, p, gw, p)
                   .permute(0, 2, 4, 3, 5, 1)          # (b, gh, gw, kh, kw, c)
                   .reshape(b, gh * gw, p * p * c))
        weight = self.patch_embedding.weight
        kernel = weight.permute(2, 3, 1, 0).reshape(-1, weight.shape[0])
        x = torch.matmul(patches, kernel)
        cls = self.class_embedding.expand(b, 1, -1)
        return torch.cat([cls, x], dim=1) + self.position_embedding.weight


class ClipVisionTransformer(nn.Module):
    def __init__(self, cfg: ClipTowerConfig):
        super().__init__()
        self.embeddings = ClipVisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.encoder = ClipEncoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size,
                                           cfg.layer_norm_eps)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(B, C, H, W) -> (B, hidden) pooled states."""
        x = self.encoder(self.pre_layrnorm(self.embeddings(pixel_values)))
        return self.post_layernorm(x[:, 0])


class ClipModel(nn.Module):
    def __init__(self, cfg: ClipConfig):
        super().__init__()
        self.cfg = cfg
        self.text_model = ClipTextTransformer(cfg.text)
        self.vision_model = ClipVisionTransformer(cfg.vision)
        self.text_projection = nn.Linear(cfg.text.hidden_size,
                                         cfg.projection_dim, bias=False)
        self.visual_projection = nn.Linear(cfg.vision.hidden_size,
                                           cfg.projection_dim, bias=False)
        self.logit_scale = nn.Parameter(torch.tensor(2.6592))

    def get_text_features(self, input_ids: torch.Tensor,
                          attention_mask: torch.Tensor) -> torch.Tensor:
        """(B, L) token ids and mask -> (B, projection_dim)."""
        return self.text_projection(self.text_model(input_ids,
                                                    attention_mask))

    def get_image_features(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(B, C, H, W) normalized pixels -> (B, projection_dim)."""
        return self.visual_projection(self.vision_model(pixel_values))

    def init_weights(self, gen: torch.Generator, std: float = 0.02
                     ) -> "ClipModel":
        """Seeded random weights (no pretrained values): every matrix,
        vector and embedding normal(0, std), LayerNorm scales 1 + that;
        drawn on the CPU in `named_parameters` order."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name == "logit_scale":
                    continue
                noise = torch.randn(p.shape, generator=gen) * std
                p.copy_(noise + 1.0 if "norm" in name
                        and name.endswith("weight") else noise)
        return self


def read_config(model_dir: str) -> ClipConfig:
    with open(os.path.join(model_dir, CONFIG_NAME)) as f:
        return ClipConfig.from_dict(json.load(f))


def load_clip(model_dir: str, device=None) -> ClipModel:
    """The CLIP of a model directory (`config.json`,
    `flax_model.msgpack`), in eval mode on `device` (default "cuda";
    without a GPU that raises unless device="cpu")."""
    from dldkd_tpu_torch import resolve_device
    from dldkd_tpu_torch.checkpoint import read_msgpack
    from dldkd_tpu_torch.convert import clip_state_dict_from_flax

    dev = resolve_device(device)
    model = ClipModel(read_config(model_dir))
    params = read_msgpack(os.path.join(model_dir, WEIGHTS_NAME))
    model.load_state_dict(clip_state_dict_from_flax(params))
    return model.to(dev).eval()


def save_clip(model: ClipModel, model_dir: str) -> None:
    """Write `config.json` and `flax_model.msgpack`, which both
    `load_clip` and `FlaxCLIPModel.from_pretrained` read."""
    from dldkd_tpu_torch.checkpoint import write_msgpack
    from dldkd_tpu_torch.convert import clip_params_to_flax

    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, CONFIG_NAME), "w") as f:
        json.dump(model.cfg.to_dict(), f, indent=2)
    write_msgpack(os.path.join(model_dir, WEIGHTS_NAME),
                  clip_params_to_flax(model.state_dict()))
