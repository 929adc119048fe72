"""Link and node prediction heads (port of ``tgm_tpu/nn/decoder/decoders.py``).

``LinkPredictor``: merge(z_src, z_dst) -> ReLU MLP -> logits.
``NodePredictor``: z_node -> ReLU MLP -> logits. ``model`` holds the MLP's
layers in order; its Linear layers are the JAX ``mlp/Dense_0``, ``Dense_1``,
... (``_MLP_0/Dense_i`` for the node head). The graph head is queued in
ROADMAP.md.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from ...exceptions import BadAggregatorProtocolError
from ..modules.aggregation import Aggregator, ConcatMerge


def _mlp(in_dim: int, out_dim: int, nlayers: int, hidden_dim: int) -> nn.Sequential:
    """The JAX ``_MLP``: ``nlayers`` Linear layers, ReLU between them."""
    layers = [nn.Linear(in_dim, hidden_dim), nn.ReLU()]
    for _ in range(1, nlayers - 1):
        layers += [nn.Linear(hidden_dim, hidden_dim), nn.ReLU()]
    layers.append(nn.Linear(hidden_dim, out_dim))
    return nn.Sequential(*layers)


class LinkPredictor(nn.Module):
    """merge(z_src, z_dst) -> MLP -> logits (B,) when out_dim == 1."""

    def __init__(
        self,
        node_dim: int,
        out_dim: int = 1,
        nlayers: int = 2,
        hidden_dim: int = 64,
        merge_op: Optional[Any] = None,
    ) -> None:
        super().__init__()
        merge = merge_op if merge_op is not None else ConcatMerge(dim=node_dim)
        if not isinstance(merge, Aggregator):
            raise BadAggregatorProtocolError(
                f"Cannot validate {type(merge).__name__}: must implement __call__ "
                "and out_channels"
            )
        self.merge = merge
        self.out_dim = out_dim
        self.model = _mlp(merge.out_channels, out_dim, nlayers, hidden_dim)

    def forward(self, z_src: torch.Tensor, z_dst: torch.Tensor) -> torch.Tensor:
        out = self.model(self.merge(z_src, z_dst))
        return out.reshape(-1) if self.out_dim == 1 else out


class NodePredictor(nn.Module):
    """z_node (S, in_dim) -> MLP -> logits (S, out_dim)."""

    def __init__(self, in_dim: int, out_dim: int = 1, nlayers: int = 2,
                 hidden_dim: int = 64) -> None:
        super().__init__()
        self.model = _mlp(in_dim, out_dim, nlayers, hidden_dim)

    def forward(self, z_node: torch.Tensor) -> torch.Tensor:
        return self.model(z_node)
