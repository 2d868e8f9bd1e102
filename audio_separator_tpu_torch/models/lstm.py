"""The LSTM shared by the VR v5.1 net and Demucs v3's BLSTM.

The JAX package runs its LSTM as a ``lax.scan`` of one cell
(``models/vr_nets._lstm_cell_scan``: gate order i, f, g, o, bias
``b_ih + b_hh``), once a direction and a layer; VR v5.1 stacks one
bidirectional layer (``_lstm_module``), Demucs v3 two (``htdemucs._blstm``).
Here that is ``nn.LSTM`` itself, which computes the same recurrence with the
same parameters and state-dict keys (``weight_ih_l{k}[_reverse]``, ...): cuDNN
on the card, ATen's loop on the CPU. It is no Pallas kernel in the JAX
package, so the library's LSTM is the port.

cuDNN's RNN follows the TF32 switch of the convolutions, so a float32 input
runs under ``ops/precision.full_float32``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.precision import full_float32


class LSTM(nn.LSTM):
    """``(T, B, input_size)`` → ``(T, B, hidden_size · directions)``: the
    output sequence of a ``num_layers`` LSTM (``bidirectional`` concatenates
    the forward and the backward direction on the last axis), zero initial
    state, computed in the parameters' dtype."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 bidirectional: bool = False):
        super().__init__(input_size, hidden_size, num_layers=num_layers,
                         bidirectional=bidirectional)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # type: ignore[override]
        """In the parameters' dtype; the output in ``x``'s."""
        with full_float32():
            out, _ = super().forward(x.to(self.weight_ih_l0.dtype))
        return out.to(x.dtype)

    @classmethod
    def from_state_shapes(cls, shapes: dict, prefix: str) -> "LSTM":
        """The LSTM whose parameters ``shapes`` (state-dict key → shape) holds
        under ``prefix``: sizes, layer count and direction read from them."""
        w_ih, w_hh = shapes[f"{prefix}.weight_ih_l0"], shapes[f"{prefix}.weight_hh_l0"]
        layers = 0
        while f"{prefix}.weight_ih_l{layers}" in shapes:
            layers += 1
        return cls(w_ih[1], w_hh[1], num_layers=layers,
                   bidirectional=f"{prefix}.weight_ih_l0_reverse" in shapes)
