"""Time2Vec time encoding (port of ``tgm_tpu/nn/modules/time_encoding.py``).

``cos(w * dt + b)`` with the log-spaced init ``w_i = 1 / 10^linspace(0, 9)``
and zero bias; weights are trainable. ``w`` is a ``Linear(1, time_dim)``
whose weight is the transpose of the JAX ``w (1, T)``.

The phase ``dt * w + b`` is rounded once, as a fused multiply-add, the
way the jitted JAX package rounds it, by one elementwise ``addcmul`` on
every device. At gaps of millions of seconds one ulp of the phase is a
quarter of a radian, so a phase rounded twice, or by a GEMM's own rule (a
``Linear`` on the card), moves ``cos`` by up to 0.25 (ROADMAP.md fault 9).
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
        return torch.cos(torch.addcmul(self.w.bias, t[..., None].float(), self.w.weight[:, 0]))
