"""GRU cell with torch's parameter layout (port of ``tgm_tpu/nn/modules/gru.py``).

The JAX ``TorchGRUCell`` exists to reproduce ``torch.nn.GRUCell`` exactly
(separate input and hidden biases, gate order reset, update, new). Here it is
``torch.nn.GRUCell``'s parameters with the JAX module's call convention:
``forward(h, x) -> (h_new, h_new)``. The gates are written out so that the
math is the JAX module's, line for line.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


class TorchGRUCell(nn.GRUCell):
    """``torch.nn.GRUCell(input_size, features)`` called as ``cell(h, x)``."""

    def __init__(self, input_size: int, features: int) -> None:
        super().__init__(input_size, features)
        self.features = features

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        H = self.features
        gi = F.linear(x, self.weight_ih, self.bias_ih)
        gh = F.linear(h, self.weight_hh, self.bias_hh)
        i_r, i_z, i_n = gi[..., :H], gi[..., H : 2 * H], gi[..., 2 * H :]
        h_r, h_z, h_n = gh[..., :H], gh[..., H : 2 * H], gh[..., 2 * H :]
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        h_new = (1.0 - z) * n + z * h
        return h_new, h_new


__all__ = ["TorchGRUCell"]
