"""Variable-length RNN encoder and time pooling (port of
dldkd_tpu/models/rnn.py; reference utils/model_utils.py:10-88, which the
DL-DKD training path does not use).

Each layer is one torch `nn.LSTM` / `nn.GRU` / `nn.RNN` (one or two
directions) run on a packed sequence (`pack_padded_sequence`,
enforce_sorted=False), which matches the flax `nn.RNN(seq_lengths=...)`
of the JAX module: a row's state stops at its length, the reverse
direction runs over each row's valid prefix only, and the outputs past a
row's length are zero. Dropout between layers (n_layers >= 2) draws from
the caller's `torch.Generator`, as components.Dropout does.

Parameter layout (`layers.<l>` is layer l; the converter,
convert.rnn_state_from_jax, maps the flax cells onto it): flax's cells and
torch's differ in which side carries a bias.
  - lstm (flax OptimizedLSTMCell): gates i, f, g, o in torch's order; the
    input kernels have no bias (bias_ih = 0), the hidden ones do;
  - gru (flax GRUCell): n = tanh(in(x) + r * hn(h)), torch's form; ir, iz
    and in carry the input bias, hn the hidden one (bias_hh of r and z
    is 0);
  - rnn (flax SimpleCell, tanh): the input side carries the bias.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from dldkd_tpu_torch.models.components import Generator, dropout

_CELLS = {"lstm": nn.LSTM, "gru": nn.GRU, "rnn": nn.RNN}


class RNNEncoder(nn.Module):
    """LSTM/GRU/RNN over padded (B, T, D) batches with per-row lengths.

    Returns (outputs, hidden):
      outputs: (B, T, n_dirs * H), zero past each row's length, or None
               when return_outputs=False;
      hidden:  (B, n_dirs * H), the last layer's final state per direction
               (LSTM: the h vector), or None when return_hidden=False.
    A zero-length row has zero outputs; its hidden state is the one after
    the whole padded row, in each direction, since flax takes the carry
    at index length - 1 = -1 (so the port runs such a row over its full
    width). allow_zero treats it as length 1 instead, as the reference's
    sort_batch does.
    """

    def __init__(self, input_size: int, hidden_size: int,
                 bidirectional: bool = True, dropout_p: float = 0.0,
                 n_layers: int = 1, rnn_type: str = "lstm",
                 return_hidden: bool = True, return_outputs: bool = True,
                 allow_zero: bool = False):
        super().__init__()
        if rnn_type not in _CELLS:
            raise ValueError(f"rnn_type must be one of {sorted(_CELLS)}")
        self.rnn_type = rnn_type
        self.dropout_p = float(dropout_p)
        self.return_hidden = return_hidden
        self.return_outputs = return_outputs
        self.allow_zero = allow_zero
        n_dirs = 2 if bidirectional else 1
        self.layers = nn.ModuleList(
            _CELLS[rnn_type](input_size if i == 0 else n_dirs * hidden_size,
                             hidden_size, batch_first=True,
                             bidirectional=bidirectional)
            for i in range(n_layers))

    def forward(self, inputs: torch.Tensor, lengths: torch.Tensor,
                generator: Generator = None
                ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        lengths = lengths.long()
        if self.allow_zero:
            lengths = torch.clamp(lengths, min=1)
        t = inputs.shape[1]
        run_len = torch.where(lengths == 0, t, lengths).cpu()
        x = inputs
        hidden = None
        for i, layer in enumerate(self.layers):
            packed, h_n = layer(pack_padded_sequence(
                x, run_len, batch_first=True, enforce_sorted=False))
            x, _ = pad_packed_sequence(packed, batch_first=True,
                                       total_length=t)
            hidden = h_n[0] if self.rnn_type == "lstm" else h_n
            if i + 1 < len(self.layers):
                x = dropout(x, self.dropout_p, self.training, generator)
        valid = torch.arange(t, device=x.device)[None, :] < \
            lengths.to(x.device)[:, None]
        outputs = (x * valid[:, :, None].to(x.dtype)
                   if self.return_outputs else None)
        if not self.return_hidden:
            return outputs, None
        return outputs, torch.cat(list(hidden), dim=-1)  # (B, n_dirs * H)


def pool_across_time(outputs: torch.Tensor, lengths: torch.Tensor,
                     pool_type: str = "max") -> torch.Tensor:
    """Masked max or mean over the time axis of (B, T, D) given per-row
    lengths; reference pool_across_time (model_utils.py:76-88), as one
    masked op. A zero-length row comes back as -inf (max) or NaN (mean),
    as in the JAX package."""
    lengths = lengths.long()
    valid = torch.arange(outputs.shape[1], device=outputs.device)[None, :] \
        < lengths[:, None]
    if pool_type == "max":
        return torch.where(valid[:, :, None], outputs,
                           float("-inf")).amax(dim=1)
    if pool_type == "mean":
        s = (outputs * valid[:, :, None].to(outputs.dtype)).sum(dim=1)
        return s / lengths[:, None].to(outputs.dtype)
    raise NotImplementedError("Only support mean and max pooling")
