"""ROLAND, a snapshot GNN with per-layer embedding updates (port of
``tgm_tpu/nn/encoder/roland.py``).

Two ``GCNConv`` layers (``conv1``, ``conv2``), each followed by ReLU and
dropout; after each layer the output is merged with the previous
snapshot's embedding of that layer by ``update``:

* ``"moving"``: tau * prev + (1 - tau) * h with tau = n_prev /
  max(n_prev + n_cur, 1), from edge counts the caller carries as device
  tensors (reading them on the host would wait for the card a snapshot);
* ``"learnable"``: the same with the parameter ``tau`` (zeros at init);
* ``"gru"``: ``gru1`` / ``gru2`` (``TorchGRUCell``) called as flax's
  ``GRUCell(carry=prev, inputs=h)``;
* ``"mlp"``: ``mlp1`` / ``mlp2`` over [h ‖ prev];
* None: the fixed ``tau0``.

The merged embeddings are detached (no backpropagation across snapshots)
and returned as the new state; the embeddings are the second merged
layer. Dropout draws from the ``generator`` passed to ``forward``; the
examples pass none.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..modules.dropout import dropout as _dropout
from ..modules.graph_conv import GCNConv
from ..modules.gru import TorchGRUCell

UPDATES = ("moving", "learnable", "gru", "mlp", None)


class ROLAND(nn.Module):
    def __init__(self, input_channel: int, out_channel: int, num_nodes: int,
                 dropout: float = 0.0, update: Optional[str] = "learnable",
                 tau0: float = 0.5) -> None:
        super().__init__()
        if update not in UPDATES:
            raise ValueError(f"Unknown update mechanism: {update}")
        self.out_channel, self.num_nodes = out_channel, num_nodes
        self.dropout, self.update, self.tau0 = dropout, update, tau0
        self.conv1 = GCNConv(input_channel, out_channel)
        self.conv2 = GCNConv(out_channel, out_channel)
        if update == "learnable":
            self.tau = nn.Parameter(torch.zeros(1))
        elif update == "gru":
            self.gru1 = TorchGRUCell(out_channel, out_channel)
            self.gru2 = TorchGRUCell(out_channel, out_channel)
            with torch.no_grad():  # flax's hr and hz Denses have no bias
                for gru in (self.gru1, self.gru2):
                    gru.bias_hh[: 2 * out_channel].zero_()
        elif update == "mlp":
            self.mlp1 = nn.Linear(2 * out_channel, out_channel)
            self.mlp2 = nn.Linear(2 * out_channel, out_channel)

    def init_embeddings(self, device=None) -> List[torch.Tensor]:
        z = torch.zeros((self.num_nodes, self.out_channel), device=device)
        return [z, z]

    def _merge(self, layer: int, h: torch.Tensor, prev: torch.Tensor, tau) -> torch.Tensor:
        if self.update == "gru":
            out, _ = (self.gru1 if layer == 0 else self.gru2)(prev, h)
        elif self.update == "mlp":
            out = (self.mlp1 if layer == 0 else self.mlp2)(torch.cat([h, prev], dim=1))
        else:
            out = tau * prev + (1 - tau) * h
        return out.detach()

    def forward(self, node_x: torch.Tensor, edge_src: torch.Tensor, edge_dst: torch.Tensor,
                previous_embeddings: Optional[List[torch.Tensor]] = None,
                num_current_edges: Optional[torch.Tensor] = None,
                num_previous_edges: Optional[torch.Tensor] = None,
                edge_valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(embeddings, [H1, H2]); the embeddings are H2."""
        if previous_embeddings is None:
            previous_embeddings = self.init_embeddings(node_x.device)
        if self.update == "moving" and num_current_edges is not None:
            tau = num_previous_edges / torch.clamp_min(num_previous_edges + num_current_edges, 1)
        elif self.update == "learnable":
            tau = self.tau
        else:
            # tau0 as the fp32 value JAX holds, so 1 - tau rounds alike.
            tau = float(np.float32(self.tau0))

        h = self.conv1(node_x, edge_src, edge_dst, None, edge_valid)
        h = _dropout(torch.relu(h), self.dropout, generator)
        h1 = self._merge(0, h, previous_embeddings[0], tau)
        h = self.conv2(h1, edge_src, edge_dst, None, edge_valid)
        h = _dropout(torch.relu(h), self.dropout, generator)
        h2 = self._merge(1, h, previous_embeddings[1], tau)
        return h2, [h1, h2]


__all__ = ["ROLAND"]
