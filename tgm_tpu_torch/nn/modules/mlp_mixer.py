"""MLP-Mixer blocks (port of ``tgm_tpu/nn/modules/mlp_mixer.py``), the
building blocks of GraphMixer and TPNet.

``MLPMixer`` is a token-mixing residual block over the neighbour (token)
axis followed by a channel-mixing one, each a LayerNorm (eps 1e-5) and a
``FeedForwardNet`` (Linear -> exact gelu -> dropout -> Linear -> dropout).
The token-mixing LayerNorm normalises the transposed (B, C, T) input over
its token axis. The LayerNorms are torch's fused ones (a two-pass
variance; flax's is E[x²] - E[x]²). On a row whose variance lies far below
eps (a seed whose neighbour slots are all padding feeds the mixer such
rows) a LayerNorm scales the roundings of x - E[x] by up to 1/sqrt(eps),
so there the two formulas end up a few 1e-5 * max of an encoder's output
apart. The fused kernel took a quarter off a GraphMixer and a TPNet train
batch on the H100 against flax's formula written out in PyTorch
(``scripts/torch_mixer_ab.py``). Every dropout mask is drawn from the
``generator`` the caller passes, and only when one is passed
(``modules/dropout.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .dropout import dropout


class FeedForwardNet(nn.Module):
    """``fc1`` (int(factor * input_dim)) -> exact gelu -> dropout -> ``fc2``
    (input_dim) -> dropout: the JAX ``Dense_0`` and ``Dense_1``."""

    def __init__(self, input_dim: int, dim_expansion_factor: float,
                 dropout: float = 0.0) -> None:
        super().__init__()
        hidden = int(dim_expansion_factor * input_dim)
        self.dropout = dropout
        self.fc1 = nn.Linear(input_dim, hidden)
        self.fc2 = nn.Linear(hidden, input_dim)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = dropout(F.gelu(self.fc1(x)), self.dropout, generator)
        return dropout(self.fc2(h), self.dropout, generator)


class MLPMixer(nn.Module):
    """Token mixing, then channel mixing, over (B, num_tokens, num_channels).

    ``token_norm`` / ``token_ffn`` and ``channel_norm`` / ``channel_ffn`` are
    the JAX ``LayerNorm_0`` / ``FeedForwardNet_0`` and ``LayerNorm_1`` /
    ``FeedForwardNet_1``.
    """

    def __init__(self, num_tokens: int, num_channels: int,
                 token_dim_expansion_factor: float = 0.5,
                 channel_dim_expansion_factor: float = 4.0, dropout: float = 0.0) -> None:
        super().__init__()
        self.token_norm = nn.LayerNorm(num_tokens, eps=1e-5)
        self.token_ffn = FeedForwardNet(num_tokens, token_dim_expansion_factor, dropout)
        self.channel_norm = nn.LayerNorm(num_channels, eps=1e-5)
        self.channel_ffn = FeedForwardNet(num_channels, channel_dim_expansion_factor, dropout)

    def forward(self, node_x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.token_ffn(self.token_norm(node_x.transpose(1, 2)), generator)  # (B, C, T)
        z = node_x + h.transpose(1, 2)
        return z + self.channel_ffn(self.channel_norm(z), generator)


__all__ = ["FeedForwardNet", "MLPMixer"]
