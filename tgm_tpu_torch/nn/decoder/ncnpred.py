"""TNCN's decoder (port of ``tgm_tpu/nn/decoder/ncnpred.py``): the Neural
Common Neighbor predictor over the batch subgraph.

For each query pair (i, j), the k-hop common-neighbour maps (k in {2, 4,
8}) are elementwise products of adjacency rows, optionally decayed by
``exp(-(t - last_update) / 10000)``; each map times the node embeddings is
one block of the CN embedding, and the score is ``xsmlp([x_i * x_j ‖ CN
blocks])``. k = 8 adds the walk corrections of the JAX package (self-walk
removal through ``-A[i, j]``, the 3-cycle diagonals, ``cn_11 @ A``) and
zeroes the query endpoints' columns.

The adjacency of the batch subgraph is symmetric with summed
multiplicities. ``_dense_adj`` builds it as a (U, U) matrix (k = 8 needs
``A @ A``). For k in {2, 4} only the seed rows are read, and
``ncn_adjacency_rows`` builds them as (S, U) counts without the JAX
package's (S, K, U) and (S, S, K) equality broadcasts: ``part1`` (each
seed row's own neighbour slots) is a ``scatter_add_`` of the slot weights,
the consolidation of duplicate seed rows an ``index_add_`` at each node's
representative row, ``gamma[r, r'] = part1[r', seed_r]`` a column gather,
and ``gamma @ onehot_seed`` an ``index_add_`` of gamma's columns at the
seeds' columns. Every value is a sum of small integers, exact in fp32 in
any order, so the rows are bit-equal to the JAX functions' (its plain and
its blocked form) on every device, atomics included. The JAX package's
blocked form for the eval seeds avoids two S²·U equality matmuls that this
construction never has; on the H100 it was 8% slower than this one at S =
4,400, U = 9,228 (``scripts/torch_tncn_ab.py``), so the port has one
builder.

``xsmlp`` is flax's ``nn.Sequential`` of ``layers_0`` (Linear), ReLU and
``layers_2`` (Linear); its input width is ``in_channels`` times 2, 4 or 8
for k = 2, 4, 8.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

_CN_BLOCKS = {2: 1, 4: 3, 8: 7}


def _dense_adj(edge_src: torch.Tensor, edge_dst: torch.Tensor, num_nodes: int,
               edge_valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Symmetric (U, U) adjacency with summed multiplicities; edge ends are
    clipped into [0, U - 1] and an invalid edge weighs 0."""
    U = num_nodes
    w = (torch.ones(edge_src.shape[0], device=edge_src.device) if edge_valid is None
         else edge_valid.float())
    src = edge_src.long().clamp(0, U - 1)
    dst = edge_dst.long().clamp(0, U - 1)
    flat = torch.zeros(U * U, device=edge_src.device)
    flat.index_add_(0, src * U + dst, w)
    flat.index_add_(0, dst * U + src, w)
    return flat.reshape(U, U)


def _valid(ids: torch.Tensor, n: int) -> torch.Tensor:
    return (ids >= 0) & (ids < n)


def _slot(ids: torch.Tensor, n: int) -> torch.Tensor:
    """int64 ids with those outside [0, n) sent to the spare slot n."""
    return torch.where(_valid(ids, n), ids, n).long()


def _part1(nbrs_local: torch.Tensor, nbr_valid: torch.Tensor, num_local: int) -> torch.Tensor:
    """(S + 1, U + 1) counts ``part1[r, u] = sum_k w[r, k] [nbr[r, k] == u]``;
    the spare row S and column U are zero."""
    S = nbrs_local.shape[0]
    out = torch.zeros(S + 1, num_local + 1, device=nbrs_local.device)
    out[:S].scatter_add_(1, _slot(nbrs_local, num_local), nbr_valid.float())
    out[:, num_local] = 0.0
    return out


def ncn_adjacency_rows(seeds_local: torch.Tensor, nbrs_local: torch.Tensor,
                       nbr_valid: torch.Tensor, num_local: int) -> torch.Tensor:
    """Adjacency rows ``A[seeds_local]`` (S, U) of the (seed_r, nbr_{r,k})
    subgraph, without building (U, U): the seed's own slots, summed over
    every seed row of the same node, plus the slots in which it is another
    seed's neighbour, at that seed's column. Rows of ids outside [0, U) are
    zero."""
    S = seeds_local.shape[0]
    U = num_local
    part1 = _part1(nbrs_local, nbr_valid, U)
    seed_slot = _slot(seeds_local, U)
    # Seed side: sum part1 over the rows of each node at its last row (ids
    # outside [0, U) at the zero row S), read back per row.
    last = torch.full((U + 1,), S, dtype=torch.long, device=part1.device)
    last.scatter_reduce_(0, seed_slot, torch.arange(S, device=part1.device), reduce="amax",
                         include_self=False)
    last[U] = S
    rep = last[seed_slot]
    rows = torch.zeros_like(part1).index_add_(0, rep, part1[:S])[rep]
    # Neighbour side: rows[r, seed_slot[r']] += gamma[r, r'] = part1[r', seed_r],
    # the edges in which seed r is the neighbour of seed r'.
    rows.index_add_(1, seed_slot, part1[:S, seed_slot].T)
    return torch.where(_valid(seeds_local, U)[:, None], rows[:, :U], 0.0)


def _one_hot_rows(ids: torch.Tensor, U: int) -> torch.Tensor:
    out = torch.zeros(ids.shape[0], U, device=ids.device)
    return out.scatter_(1, ids[:, None], 1.0)


class NCNPredictor(nn.Module):
    """``forward(x, edge_src, edge_dst, tar_i, tar_j, last_update=None,
    edge_time=None, edge_valid=None) -> (B,)`` scores over the dense
    adjacency of the local edges; ``score_from_rows(x, row1_i, row1_j,
    tar_i, tar_j, ...)`` from precomputed adjacency rows (k in {2, 4}).
    ``pair_features`` gives the MLP's input rows of either form.
    """

    def __init__(self, in_channels: int, hidden_dim: int, out_channels: int, k: int = 2,
                 cn_time_decay: bool = False) -> None:
        super().__init__()
        if k not in _CN_BLOCKS:
            raise ValueError("Please choose k from [2,4,8]")
        self.k = k
        self.cn_time_decay = cn_time_decay
        self.xsmlp = nn.Sequential(nn.Linear(in_channels * (1 + _CN_BLOCKS[k]), hidden_dim),
                                   nn.ReLU(), nn.Linear(hidden_dim, out_channels))

    def get_cn_emb(self, x: torch.Tensor, A: Optional[torch.Tensor], tar_i: torch.Tensor,
                   tar_j: torch.Tensor, last_update: Optional[torch.Tensor] = None,
                   pos_t: Optional[torch.Tensor] = None, row1_i: Optional[torch.Tensor] = None,
                   row1_j: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, D * blocks): the CN maps of the (tar_i, tar_j) pairs times
        ``x``; the rows come from ``A`` unless given."""
        U = x.shape[0]
        i = tar_i.long().clamp(0, U - 1)
        j = tar_j.long().clamp(0, U - 1)

        decay = None
        if self.cn_time_decay:
            if last_update is None or pos_t is None:
                raise RuntimeError("Provide time info to perform time decay")
            decay = torch.exp(-(pos_t[:, None] - last_update[None, :]).float() / 10000.0)

        if row1_i is None:
            row1_i, row1_j = A[i], A[j]

        def dec(m):
            return m * decay if decay is not None else m

        if self.k == 2:
            return dec(row1_i * row1_j) @ x
        row0_i, row0_j = _one_hot_rows(i, U), _one_hot_rows(j, U)
        if self.k == 4:
            return torch.cat([dec(row0_i * row1_j) @ x, dec(row1_i * row0_j) @ x,
                              dec(row1_i * row1_j) @ x], dim=-1)
        A2 = A @ A
        k3 = A2 @ A
        row2_i, row2_j = A2[i], A2[j]
        cn_01 = row0_i * row1_j
        cn_10 = row1_i * row0_j
        cn_11 = row1_i * row1_j
        u_v = -A[i, j][:, None]
        cn_12 = row1_i * row2_j + row1_i * row1_i * u_v
        cn_21 = row2_i * row1_j + row1_j * row1_j * u_v
        ind_i = (row1_i != 0).to(x.dtype)
        ind_j = (row1_j != 0).to(x.dtype)
        special_22 = cn_11 @ A
        delta_22 = (ind_i * k3[i, i][:, None] + ind_j * k3[j, j][:, None] - cn_11) * u_v
        cn_22 = row2_i * row2_j + (delta_22 + special_22)
        # Zero the query endpoints' columns of the higher-order maps.
        mask = torch.ones_like(cn_12)
        rng = torch.arange(i.shape[0], device=x.device)
        mask[rng, i] = 0.0
        mask[rng, j] = 0.0
        cn_12 = cn_12 * mask
        cn_21 = cn_21 * mask
        cn_22 = torch.clamp_min(cn_22 * mask, 0.0)
        maps = [cn_01, cn_10, cn_11, cn_12, cn_21, cn_22]
        return torch.cat([dec(m) @ x for m in maps] + [special_22 @ x], dim=-1)

    def pair_features(self, x: torch.Tensor, tar_i: torch.Tensor, tar_j: torch.Tensor,
                      A: Optional[torch.Tensor] = None, row1_i: Optional[torch.Tensor] = None,
                      row1_j: Optional[torch.Tensor] = None,
                      last_update: Optional[torch.Tensor] = None,
                      edge_time: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The MLP's input rows [x_i * x_j ‖ CN embedding] of the pairs."""
        U = x.shape[0]
        xij = x[tar_i.long().clamp(0, U - 1)] * x[tar_j.long().clamp(0, U - 1)]
        cn = self.get_cn_emb(x, A, tar_i, tar_j, last_update, edge_time, row1_i, row1_j)
        return torch.cat([xij, cn], dim=-1)

    def forward(self, x: torch.Tensor, edge_src: torch.Tensor, edge_dst: torch.Tensor,
                tar_i: torch.Tensor, tar_j: torch.Tensor,
                last_update: Optional[torch.Tensor] = None,
                edge_time: Optional[torch.Tensor] = None,
                edge_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        A = _dense_adj(edge_src, edge_dst, x.shape[0], edge_valid)
        xs = self.pair_features(x, tar_i, tar_j, A=A, last_update=last_update,
                                edge_time=edge_time)
        return self.xsmlp(xs).reshape(-1)

    def score_from_rows(self, x: torch.Tensor, row1_i: torch.Tensor, row1_j: torch.Tensor,
                        tar_i: torch.Tensor, tar_j: torch.Tensor,
                        last_update: Optional[torch.Tensor] = None,
                        edge_time: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Scores from precomputed adjacency rows (``ncn_adjacency_rows``); k =
        8 needs the dense adjacency's products: use ``forward``."""
        if self.k == 8:
            raise ValueError("score_from_rows supports k in {2, 4}")
        xs = self.pair_features(x, tar_i, tar_j, row1_i=row1_i, row1_j=row1_j,
                                last_update=last_update, edge_time=edge_time)
        return self.xsmlp(xs).reshape(-1)


__all__ = ["NCNPredictor", "ncn_adjacency_rows"]
