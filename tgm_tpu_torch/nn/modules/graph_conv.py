"""Spectral graph convolutions on COO edge lists (port of
``tgm_tpu/nn/modules/graph_conv.py``).

Symmetric-normalised sparse products written as gather + ``segment_sum``
(``ops/segment.py``) over padded COO edges with a validity mask, as in
JAX:

* ``GCNConv``: self loops A + I (A + 2I when ``improved``, none without
  ``add_self_loops``), D^-1/2 (A + cI) D^-1/2 applied to X W, then the bias;
* ``ChebConv`` (symmetric normalisation, lambda_max = 2): the scaled
  Laplacian L = -D^-1/2 A D^-1/2 and the Chebyshev recurrence
  Z_k = 2 L Z_{k-1} - Z_{k-2}, one bias-free ``Linear`` a term (``lin_k``).

Ids are clipped into [0, n - 1], n being ``x``'s row count (there is no
dump row here), so a padded -1 reads and writes row 0 as a JAX gather
clamps it; padded edges weigh 0 when ``edge_valid`` is given. The degree is
taken over ``edge_dst`` plus the self-loop weight, and ``D^-1/2`` is 0
where the degree is 0. The JAX package has no Pallas kernel here, so
neither has the port: these are plain PyTorch and differentiate through
autograd.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ...ops.segment import segment_sum


def _sym_norm_weights(
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    edge_weight: Optional[torch.Tensor],
    edge_valid: Optional[torch.Tensor],
    num_nodes: int,
    self_loop_weight: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(norm_edge_w, deg_inv_sqrt) of D^-1/2 (A [+ cI]) D^-1/2."""
    w = (torch.ones(edge_src.shape[0], device=edge_src.device) if edge_weight is None
         else edge_weight)
    if edge_valid is not None:
        w = torch.where(edge_valid, w, 0.0)
    src = edge_src.long().clamp(0, num_nodes - 1)
    dst = edge_dst.long().clamp(0, num_nodes - 1)
    deg = segment_sum(w, dst, num_nodes) + self_loop_weight
    dis = torch.where(deg > 0, 1.0 / torch.sqrt(deg.clamp_min(1e-12)), 0.0)
    return dis[src] * w * dis[dst], dis


def gcn_propagate(
    x: torch.Tensor,
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    edge_weight: Optional[torch.Tensor],
    edge_valid: Optional[torch.Tensor],
    self_loop_weight: float = 1.0,
) -> torch.Tensor:
    """D^-1/2 (A + cI) D^-1/2 @ x over masked COO edges."""
    n = x.shape[0]
    norm_w, dis = _sym_norm_weights(edge_src, edge_dst, edge_weight, edge_valid, n,
                                    self_loop_weight)
    src = edge_src.long().clamp(0, n - 1)
    dst = edge_dst.long().clamp(0, n - 1)
    agg = segment_sum(x[src] * norm_w[:, None], dst, n, edge_valid)
    # The self loop: c * d_i^-1 * x_i, normalised alike.
    return agg + x * (self_loop_weight * dis * dis)[:, None]


def laplacian_propagate(
    x: torch.Tensor,
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    edge_weight: Optional[torch.Tensor],
    edge_valid: Optional[torch.Tensor],
) -> torch.Tensor:
    """L @ x with L = -D^-1/2 A D^-1/2 (symmetric normalisation, lambda_max = 2)."""
    n = x.shape[0]
    norm_w, _ = _sym_norm_weights(edge_src, edge_dst, edge_weight, edge_valid, n, 0.0)
    src = edge_src.long().clamp(0, n - 1)
    dst = edge_dst.long().clamp(0, n - 1)
    return -segment_sum(x[src] * norm_w[:, None], dst, n, edge_valid)


class GCNConv(nn.Module):
    """The JAX ``GCNConv``: ``lin`` (its ``Dense_0``, no bias) then the
    normalised propagation, then ``bias`` (zeros at init)."""

    def __init__(self, in_channels: int, out_channels: int, improved: bool = False,
                 add_self_loops: bool = True, use_bias: bool = True) -> None:
        super().__init__()
        self.lin = nn.Linear(in_channels, out_channels, bias=False)
        self.self_loop_weight = (2.0 if improved else 1.0) if add_self_loops else 0.0
        self.bias = nn.Parameter(torch.zeros(out_channels)) if use_bias else None

    def forward(self, x: torch.Tensor, edge_src: torch.Tensor, edge_dst: torch.Tensor,
                edge_weight: Optional[torch.Tensor] = None,
                edge_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = gcn_propagate(self.lin(x), edge_src, edge_dst, edge_weight, edge_valid,
                            self.self_loop_weight)
        return out if self.bias is None else out + self.bias


class ChebConv(nn.Module):
    """The JAX ``ChebConv`` of order ``K``: ``lins[k]`` is its ``lin_k`` (no
    bias), then ``bias`` (zeros at init). At ``K = 1`` it is ``lin_0(x) +
    bias`` and reads no edge."""

    def __init__(self, in_channels: int, out_channels: int, K: int,
                 use_bias: bool = True) -> None:
        super().__init__()
        if K < 1:
            raise ValueError(f"K must be at least 1, got {K}")
        self.lins = nn.ModuleList(nn.Linear(in_channels, out_channels, bias=False)
                                  for _ in range(K))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if use_bias else None

    def forward(self, x: torch.Tensor, edge_src: torch.Tensor, edge_dst: torch.Tensor,
                edge_weight: Optional[torch.Tensor] = None,
                edge_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        z_prev2 = x
        out = self.lins[0](z_prev2)
        if len(self.lins) > 1:
            z_prev1 = laplacian_propagate(x, edge_src, edge_dst, edge_weight, edge_valid)
            out = out + self.lins[1](z_prev1)
            for lin in self.lins[2:]:
                z_k = 2.0 * laplacian_propagate(z_prev1, edge_src, edge_dst, edge_weight,
                                                edge_valid) - z_prev2
                out = out + lin(z_k)
                z_prev2, z_prev1 = z_prev1, z_k
        return out if self.bias is None else out + self.bias


__all__ = ["ChebConv", "GCNConv", "gcn_propagate", "laplacian_propagate"]
