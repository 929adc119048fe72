"""Link, node and graph prediction heads (port of ``tgm_tpu/nn/decoder/decoders.py``).

``LinkPredictor``: merge(z_src, z_dst) -> ReLU MLP -> logits.
``NodePredictor``: z_node -> ReLU MLP -> logits. ``GraphPredictor``:
pool(z_nodes) -> ReLU MLP -> logits. ``model`` holds the MLP's layers in
order; its Linear layers are the JAX ``mlp/Dense_0``, ``Dense_1``, ... (of
the link and graph heads; ``_MLP_0/Dense_i`` for the node head).
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from ...exceptions import BadAggregatorProtocolError
from ..modules.aggregation import Aggregator, ConcatMerge, MeanEmbdPooling


def _mlp(in_dim: int, out_dim: int, nlayers: int, hidden_dim: int) -> nn.Sequential:
    """The JAX ``_MLP``: ``nlayers`` Linear layers, ReLU between them."""
    layers = [nn.Linear(in_dim, hidden_dim), nn.ReLU()]
    for _ in range(1, nlayers - 1):
        layers += [nn.Linear(hidden_dim, hidden_dim), nn.ReLU()]
    layers.append(nn.Linear(hidden_dim, out_dim))
    return nn.Sequential(*layers)


def _checked(aggregator: Any) -> Any:
    if not isinstance(aggregator, Aggregator):
        raise BadAggregatorProtocolError(
            f"Cannot validate {type(aggregator).__name__}: must implement __call__ "
            "and out_channels"
        )
    return aggregator


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
        merge = _checked(merge_op if merge_op is not None else ConcatMerge(dim=node_dim))
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


class GraphPredictor(nn.Module):
    """z_nodes (N, in_dim) -> pooling (``MeanEmbdPooling`` unless
    ``graph_pooling`` is given) -> MLP -> logits (out_dim,). The MLP reads
    the pooling's ``out_channels`` features."""

    def __init__(self, in_dim: int, out_dim: int = 1, nlayers: int = 2, hidden_dim: int = 64,
                 graph_pooling: Optional[Any] = None) -> None:
        super().__init__()
        self.pooling = _checked(graph_pooling if graph_pooling is not None
                                else MeanEmbdPooling(dim=in_dim))
        self.model = _mlp(self.pooling.out_channels, out_dim, nlayers, hidden_dim)

    def forward(self, z_nodes: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.model(self.pooling(z_nodes, valid))
