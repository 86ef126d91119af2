"""The DLDKD dual-branch retrieval model (port of dldkd_tpu/models/dldkd.py).

Per branch ("inheritance" always, "exploration" when double_branch): a
query tower (input proj -> learned positions -> one attention block ->
softmax pooling to one vector) and a video tower (the same shape with its
own weights, plus an output linear). Reference DLDKD, method/model.py:13-258.

The reference keeps both branches' modules flat on the model, the
exploration ones under an `exp_` prefix, and so does this module: its
`state_dict` carries the reference names. `Branch` groups one branch's
modules for the encode methods; DLDKD registers them under the flat names
and keeps the `Branch` objects in a plain tuple, so each parameter appears
once in the state_dict.

`ModelConfig.dtype` is the towers' compute dtype (components.py: f32
parameters, bf16 products and LayerNorm outputs where flax rounds them);
the pooled query comes out f32 and the frame features in the compute
dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from dldkd_tpu_torch.config import ModelConfig
from dldkd_tpu_torch.models.components import (AttentionBlock, Generator,
                                               LinearInputProj,
                                               TrainablePositionalEncoding,
                                               compute_dtype, dense)
from dldkd_tpu_torch.ops.masking import mask_logits

BRANCH_PREFIX = {"inheritance": "", "exploration": "exp_"}


class Branch(nn.Module):
    """One student branch: query tower + video tower."""

    def __init__(self, cfg: ModelConfig, hidden: int):
        super().__init__()
        self.dtype = dt = compute_dtype(cfg.dtype)
        self.query_input_proj = LinearInputProj(
            cfg.query_input_size, hidden, cfg.input_drop, dt)
        self.query_pos_embed = TrainablePositionalEncoding(
            cfg.max_desc_l, hidden, cfg.input_drop, dt)
        self.query_encoder = AttentionBlock(hidden, cfg.n_heads, cfg.drop,
                                            cfg.drop, dt)
        self.modular_vector_mapping = nn.Linear(hidden, 1, bias=False)
        self.visual_input_proj = LinearInputProj(
            cfg.visual_input_size, hidden, cfg.input_drop, dt)
        self.visual_pos_embed = TrainablePositionalEncoding(
            cfg.max_ctx_l, hidden, cfg.input_drop, dt)
        self.visual_encoder = AttentionBlock(hidden, cfg.n_heads, cfg.drop,
                                             cfg.drop, dt)
        self.out_mapping_linear = nn.Linear(hidden, hidden)

    def encode_query(self, feat: torch.Tensor, mask: torch.Tensor,
                     generator: Generator = None) -> torch.Tensor:
        """(Nq, Lq, Dq), (Nq, Lq) -> pooled (Nq, hidden): encode tokens,
        then softmax-pool with the learned 1-d attention head (reference
        encode_query + get_modularized_queries, model.py:199-258)."""
        x = self.query_input_proj(feat, generator)
        x = self.query_pos_embed(x, generator)
        x = self.query_encoder(x, mask, generator)
        mv = self.modular_vector_mapping
        att = dense(x, mv.weight, None, self.dtype)           # (Nq,Lq,1)
        att = torch.softmax(mask_logits(att, mask[:, :, None]), dim=1)
        return (att * x).sum(dim=1)

    def encode_context(self, feat: torch.Tensor, mask: torch.Tensor,
                       generator: Generator = None) -> torch.Tensor:
        """(Nv, Lv, Dv), (Nv, Lv) -> frame features (Nv, Lv, hidden)
        (reference encode_context, model.py:215-227)."""
        x = self.visual_input_proj(feat, generator)
        x = self.visual_pos_embed(x, generator)
        x = self.visual_encoder(x, mask, generator)
        out = self.out_mapping_linear
        return dense(x, out.weight, out.bias, self.dtype)


class DLDKD(nn.Module):
    """Dual-branch student. Teacher features are inputs, never weights."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config
        names = ["inheritance"] + (["exploration"] if config.double_branch
                                   else [])
        hiddens = {"inheritance": config.inheritance_hidden,
                   "exploration": config.exploration_hidden}
        branches = []
        for name in names:
            br = Branch(config, hiddens[name])
            for child, mod in br.named_children():
                self.add_module(BRANCH_PREFIX[name] + child, mod)
            branches.append(br)
        self.branch_names = tuple(names)
        self.branches = tuple(branches)   # not registered: see module doc

    def init_weights(self, generator: torch.Generator) -> "DLDKD":
        """The reference init (model.py:80-93): normal(0,
        initializer_range) weights and embeddings, zero biases, unit
        LayerNorms; draws come from `generator`."""
        std = self.config.initializer_range
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, (nn.Linear, nn.Embedding)):
                    mod.weight.normal_(0.0, std, generator=generator)
                    if getattr(mod, "bias", None) is not None:
                        mod.bias.zero_()
                elif isinstance(mod, nn.LayerNorm):
                    mod.weight.fill_(1.0)
                    mod.bias.zero_()
        return self

    def encode_query(self, feat, mask, generator: Generator = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        outs = [br.encode_query(feat, mask, generator)
                for br in self.branches]
        return outs[0], (outs[1] if len(outs) > 1 else None)

    def encode_context(self, feat, mask, generator: Generator = None
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        outs = [br.encode_context(feat, mask, generator)
                for br in self.branches]
        return outs[0], (outs[1] if len(outs) > 1 else None)

    def forward(self, video_feat, video_mask, query_feat, query_mask,
                generator: Generator = None):
        """The training forward (dldkd.py:123-128): both modalities through
        every branch, ((ctx_inher, ctx_explore), (q_inher, q_explore)).
        In training mode with dropout on, `generator` gives every mask."""
        ctx = self.encode_context(video_feat, video_mask, generator)
        qry = self.encode_query(query_feat, query_mask, generator)
        return ctx, qry
