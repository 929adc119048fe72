"""TGCN, the temporal GCN gated recurrent cell (port of ``tgm_tpu/nn/encoder/tgcn.py``).

One ``GCNConv`` a gate over the node features, then a ``Linear`` over
[conv(X) ‖ H] with sigmoid or tanh; H' = U * H + (1 - U) * C. Module names
are the JAX ones: ``conv_{u,r,c}`` and ``linear_{u,r,c}``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..modules.graph_conv import GCNConv


class TGCN(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, improved: bool = False,
                 add_self_loops: bool = True) -> None:
        super().__init__()
        self.out_channels = out_channels
        conv = lambda: GCNConv(in_channels, out_channels, improved=improved,
                               add_self_loops=add_self_loops)
        self.conv_u, self.conv_r, self.conv_c = conv(), conv(), conv()
        self.linear_u = nn.Linear(2 * out_channels, out_channels)
        self.linear_r = nn.Linear(2 * out_channels, out_channels)
        self.linear_c = nn.Linear(2 * out_channels, out_channels)

    def forward(self, node_x: torch.Tensor, edge_src: torch.Tensor, edge_dst: torch.Tensor,
                edge_weight: Optional[torch.Tensor] = None, H: Optional[torch.Tensor] = None,
                edge_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        if H is None:
            H = node_x.new_zeros((node_x.shape[0], self.out_channels))
        conv = lambda m: m(node_x, edge_src, edge_dst, edge_weight, edge_valid)
        U = torch.sigmoid(self.linear_u(torch.cat([conv(self.conv_u), H], 1)))
        R = torch.sigmoid(self.linear_r(torch.cat([conv(self.conv_r), H], 1)))
        C = torch.tanh(self.linear_c(torch.cat([conv(self.conv_c), H * R], 1)))
        return U * H + (1 - U) * C


__all__ = ["TGCN"]
