"""Time2Vec time encoding (port of ``tgm_tpu/nn/modules/time_encoding.py``).

``cos(w * dt + b)`` with the log-spaced init ``w_i = 1 / 10^linspace(0, 9)``
and zero bias; weights are trainable. ``w`` is a ``Linear(1, time_dim)``
whose weight is the transpose of the JAX ``w (1, T)``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


class Time2Vec(nn.Module):
    def __init__(self, time_dim: int) -> None:
        super().__init__()
        self.time_dim = time_dim
        self.w = nn.Linear(1, time_dim)
        with torch.no_grad():
            w = (1 / 10 ** np.linspace(0, 9, time_dim)).astype(np.float32)
            self.w.weight.copy_(torch.from_numpy(w).reshape(time_dim, 1))
            self.w.bias.zero_()

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        """t: (...,) -> (..., time_dim)."""
        return torch.cos(self.w(t[..., None].float()))
