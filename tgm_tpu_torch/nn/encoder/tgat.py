"""TGAT: temporal graph attention (port of ``tgm_tpu/nn/encoder/tgat.py``).

Multi-layer temporal attention over a seed's sampled k-hop neighbourhood,
computed with the dynamic-programming table ``z[layer][hop]``: the layer-j
embedding of the hop-i nodes attends over the layer-(j-1) embeddings of
their hop-(i+1) neighbours, and a ``MergeLayer`` (two-layer MLP) merges the
result with the hop-i nodes' raw features. Seeds encode themselves with a
zero time delta, neighbours with the gap to their seed's time.

Raw node features are looked up torch-style: PAD (-1) wraps to the LAST
node row, written out here rather than left to negative indexing. Padded
slots are masked in the attention, but a row with no valid neighbour
softmaxes uniformly over them, so parity with the reference needs that same
row. ``nbr_kv_x`` feeds the deepest hop's [node ‖ edge] K/V input as rows of
a side-augmented table (``train/tgat_pipeline.py::build_aug_table``).
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ...constants import PADDED_NODE_ID
from ..modules.attention import TemporalAttention
from ..modules.time_encoding import Time2Vec


class MergeLayer(nn.Module):
    """``Linear(in, hidden) -> ReLU -> Linear(hidden, out)`` over [x1 ‖ x2]
    (the JAX ``Dense_0`` and ``Dense_1``)."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int) -> None:
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, output_dim)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.relu(self.fc1(torch.cat([x1, x2], dim=-1))))


class TGAT(nn.Module):
    """The JAX constructor's fields; ``dropout`` is drawn only from the
    ``generator`` passed to ``forward``."""

    requires = frozenset({"seed_nids", "seed_times", "nbr_nids", "nbr_edge_x", "nbr_edge_time"})

    def __init__(
        self,
        node_dim: int,
        edge_dim: int,
        time_dim: int,
        embed_dim: int,
        num_layers: int,
        n_heads: int = 2,
        dropout: float = 0.1,
        kv_bf16: bool = False,
        score_layout: str = "kmajor",
    ) -> None:
        super().__init__()
        self.num_layers = num_layers
        self.time_encoder = Time2Vec(time_dim)
        self.attn = nn.ModuleList(
            TemporalAttention(n_heads, node_dim if i == 0 else embed_dim, edge_dim, time_dim,
                              dropout, kv_bf16, score_layout)
            for i in range(num_layers)
        )
        self.merge_layers = nn.ModuleList(
            MergeLayer(a.out_dim + node_dim, embed_dim, embed_dim) for a in self.attn
        )

    def forward(
        self,
        node_x: torch.Tensor,  # (num_nodes, node_dim)
        seed_nids: List[torch.Tensor],  # per hop: (S_i,)
        seed_times: List[torch.Tensor],  # per hop: (S_i,)
        nbr_nids: List[torch.Tensor],  # per hop: (S_i, K_i)
        nbr_edge_x: List[torch.Tensor],  # per hop: (S_i, K_i, edge_dim)
        nbr_edge_time: List[torch.Tensor],  # per hop: (S_i, K_i)
        generator: Optional[torch.Generator] = None,
        nbr_kv_x: Optional[List[Optional[torch.Tensor]]] = None,  # per hop: (S_i, K_i, node+edge)
    ) -> torch.Tensor:
        """(S_0, embed_dim) embeddings of the hop-0 seeds."""
        n = node_x.shape[0]

        def feats(ids: torch.Tensor) -> torch.Tensor:
            ids = ids.long()
            return node_x[torch.where(ids < 0, ids + n, ids).clamp(0, n - 1)]

        def kv(i: int) -> Optional[torch.Tensor]:
            return None if nbr_kv_x is None else nbr_kv_x[i]

        L = self.num_layers
        # z[j][i]: layer-j embedding of the hop-i nodes.
        z = [[None] * (L + 1) for _ in range(L + 1)]
        z[0][0] = feats(seed_nids[0])
        for i in range(1, L + 1):
            # The deepest hop's node features may arrive inside nbr_kv_x; its
            # only reader is the layer-1 attention's K/V input.
            if not (i == L and kv(i - 1) is not None):
                z[0][i] = feats(nbr_nids[i - 1].reshape(-1))

        for j in range(1, L + 1):
            for i in range(L - j + 1):
                num_nodes = z[j - 1][i].shape[0]
                num_nbr = nbr_nids[i].shape[-1]
                fused = j == 1 and kv(i) is not None
                rel_t = (seed_times[i][:, None] - nbr_edge_time[i]).float()
                out = self.attn[j - 1](
                    z[j - 1][i],
                    self.time_encoder(torch.zeros(num_nodes, device=node_x.device)),
                    None if fused else nbr_edge_x[i],
                    None if fused else z[j - 1][i + 1].reshape(num_nodes, num_nbr, -1),
                    self.time_encoder(rel_t),
                    nbr_nids[i] != PADDED_NODE_ID,
                    generator=generator,
                    kv_node_edge_feat=kv(i) if fused else None,
                )
                z[j][i] = self.merge_layers[j - 1](out, z[0][i])
        return z[L][0]


__all__ = ["MergeLayer", "TGAT"]
