"""GC-LSTM, the graph-convolutional LSTM cell (port of ``tgm_tpu/nn/encoder/gclstm.py``).

Each gate adds a dense input term ``node_x @ W_*`` (the raw (in, out)
weight, no transpose: Glorot-uniform at init) to a ``ChebConv`` over the
hidden state and a ``(1, out)`` bias (zeros at init); then the LSTM cell's
combination. At ``K = 1`` the convolutions read no edge (``ChebConv``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..modules.graph_conv import ChebConv

GATES = ("i", "f", "c", "o")


class GCLSTM(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, K: int) -> None:
        super().__init__()
        self.out_channels = out_channels
        for g in GATES:
            w = nn.Parameter(torch.empty(in_channels, out_channels))
            nn.init.xavier_uniform_(w)
            setattr(self, f"W_{g}", w)
            setattr(self, f"b_{g}", nn.Parameter(torch.zeros(1, out_channels)))
            setattr(self, f"conv_{g}", ChebConv(out_channels, out_channels, K))

    def forward(self, node_x: torch.Tensor, edge_src: torch.Tensor, edge_dst: torch.Tensor,
                edge_weight: Optional[torch.Tensor] = None, H: Optional[torch.Tensor] = None,
                C: Optional[torch.Tensor] = None,
                edge_valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        n = node_x.shape[0]
        if H is None:
            H = node_x.new_zeros((n, self.out_channels))
        if C is None:
            C = node_x.new_zeros((n, self.out_channels))

        def gate(g: str) -> torch.Tensor:
            conv = getattr(self, f"conv_{g}")(H, edge_src, edge_dst, edge_weight, edge_valid)
            return node_x @ getattr(self, f"W_{g}") + conv + getattr(self, f"b_{g}")

        I = torch.sigmoid(gate("i"))
        F = torch.sigmoid(gate("f"))
        T = torch.tanh(gate("c"))
        C = F * C + I * T
        O = torch.sigmoid(gate("o"))
        return O * torch.tanh(C), C


__all__ = ["GCLSTM"]
