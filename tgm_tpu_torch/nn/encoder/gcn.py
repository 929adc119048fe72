"""Multi-layer GCN encoder for snapshot tasks (port of ``tgm_tpu/nn/encoder/gcn.py``).

``num_layers`` ``GCNConv`` layers (``convs[i]``, the JAX ``GCNConv_i``),
ReLU and dropout between them. Dropout draws from the ``torch.Generator``
passed to ``forward``; without one (the examples' use) there is none.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..modules.dropout import dropout as _dropout
from ..modules.graph_conv import GCNConv


class GCN(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, num_layers: int = 2,
                 dropout: float = 0.0) -> None:
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        self.convs = nn.ModuleList(GCNConv(a, b) for a, b in zip(dims, dims[1:]))
        self.dropout = dropout

    def forward(self, node_x: torch.Tensor, edge_src: torch.Tensor, edge_dst: torch.Tensor,
                edge_weight: Optional[torch.Tensor] = None,
                edge_valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = node_x
        for conv in self.convs[:-1]:
            h = torch.relu(conv(h, edge_src, edge_dst, edge_weight, edge_valid))
            h = _dropout(h, self.dropout, generator)
        return self.convs[-1](h, edge_src, edge_dst, edge_weight, edge_valid)


__all__ = ["GCN"]
