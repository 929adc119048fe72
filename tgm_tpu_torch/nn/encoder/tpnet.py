"""TPNet (port of ``tgm_tpu/nn/encoder/tpnet.py``): temporal-walk-matrix
random projections and an MLP-Mixer encoder.

The random-projection state is ``(L+1, N+1, dim)`` decayed projection
matrices ``P_0..P_L`` and a ``now_time``. ``P_0`` is fixed: the identity
with ``use_matrix``, else N(0, 1/dim) rows drawn from a ``torch.Generator``
(the JAX package draws them with ``jax.random``: ROADMAP fault 5), every
one of the N + 1 rows, the dump row N included. ``rp_update`` decays every
layer to the batch's latest time and propagates each valid edge from layer
i-1 into layer i, in both directions, from layer L down to 1, so each
layer reads its lower layer decayed but not yet updated. The pairwise
features of a (u, v) pair are the inner products of u's and v's stacked
projections (log1p of their positive part), through a ReLU MLP.

``TPNet`` projects each neighbour's [node ‖ Time2Vec(log Δt) ‖ edge ‖ RP
features] through a two-layer MLP, runs the ``MLPMixer`` blocks over the
(2B, K, output_dim) sequences and mean-pools. The pair features are plain
PyTorch (gathers and ``einsum``), as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Set, Tuple

import torch
from torch import nn

from ...constants import PADDED_NODE_ID
from ..modules.mlp_mixer import MLPMixer
from ..modules.time_encoding import Time2Vec

class RandomProjectionState(NamedTuple):
    projections: torch.Tensor  # (L+1, N+1, dim) fp32; layer 0 is the fixed base
    now_time: torch.Tensor  # () fp32


def rp_init_state(num_nodes: int, num_layer: int, dim: int, beginning_time: float,
                  use_matrix: bool,
                  generator: Optional[torch.Generator] = None) -> RandomProjectionState:
    """Layer 0 the identity (``use_matrix``) or N(0, 1) / sqrt(dim) drawn from
    ``generator``, layers 1..L zero, ``now_time`` the beginning; on the
    generator's device (the CPU without one)."""
    n = num_nodes + 1
    device = generator.device if generator is not None else torch.device("cpu")
    if use_matrix:
        base = torch.eye(n, dim, device=device)
    else:
        base = torch.randn(n, dim, generator=generator, device=device) / math.sqrt(dim)
    proj = torch.cat([base[None], torch.zeros(num_layer, n, dim, device=device)])
    return RandomProjectionState(proj, torch.tensor(float(beginning_time), device=device))


def rp_update(state: RandomProjectionState, src: torch.Tensor, dst: torch.Tensor,
              time: torch.Tensor, valid: Optional[torch.Tensor],
              time_decay_weight: float) -> RandomProjectionState:
    """Decay every layer to the batch's latest valid time, then propagate.

    Returns a new state; ``state`` is left as it is (a backup stays valid).
    For i = L..1, layer i adds ``w * P_{i-1}[dst]`` at the src rows, then
    ``w * P_{i-1}[src]`` at the dst rows, with ``w = exp(-λ (next - t))``;
    invalid rows go to the dump row, which is then zeroed. The adds run in
    index order on the CPU; on the card ``index_add_`` uses atomics, so the
    sum order (and the last bits) may vary between runs.
    """
    if src.numel() == 0:
        raise ValueError("rp_update: an empty batch has no latest time")
    proj = state.projections
    L = proj.shape[0] - 1
    n = proj.shape[1] - 1
    if valid is None:
        valid = torch.ones(src.shape[0], dtype=torch.bool, device=src.device)
    t_f = time.float()
    next_time = torch.where(valid, t_f, -torch.inf).max()
    next_time = torch.maximum(next_time, state.now_time)
    w = torch.exp(-time_decay_weight * (next_time - t_f)) * valid
    decay = torch.exp(-time_decay_weight * (next_time - state.now_time))
    ar = torch.arange(1, L + 1, dtype=torch.float32, device=proj.device)
    scales = torch.cat([torch.ones(1, device=proj.device), decay ** ar])
    proj = proj * scales[:, None, None]  # a new tensor: the update runs in place on it

    s_rows = torch.where(valid, src, n).long()
    d_rows = torch.where(valid, dst, n).long()
    w = w[:, None]
    # Descending, so layer i reads layer i-1 before that layer's own update.
    for i in range(L, 0, -1):
        layer, lower = proj[i], proj[i - 1]
        layer.index_add_(0, s_rows, lower[d_rows] * w)
        layer.index_add_(0, d_rows, lower[s_rows] * w)
        layer[n] = 0.0
    return RandomProjectionState(proj, next_time)


class RandomProjectionModule(nn.Module):
    """Pairwise random-projection features: a ReLU MLP (``Dense_0``,
    ``Dense_1`` in JAX; ``fc1``, ``fc2`` here) over the inner products of the
    two ids' stacked projections. Ids outside [0, N) read the dump row N.
    """

    def __init__(self, num_nodes: int, num_layer: int, time_decay_weight: float,
                 beginning_time: float = 0.0, use_matrix: bool = True,
                 scale_random_projection: bool = True, enforce_dim: Optional[int] = None,
                 num_edges: Optional[int] = None, dim_factor: Optional[int] = None,
                 concat_src_dst: bool = True) -> None:
        super().__init__()
        self.num_nodes = num_nodes
        self.num_layer = num_layer
        self.time_decay_weight = time_decay_weight
        self.beginning_time = beginning_time
        self.use_matrix = use_matrix
        self.scale_random_projection = scale_random_projection
        self.enforce_dim = enforce_dim
        self.num_edges = num_edges
        self.dim_factor = dim_factor
        self.concat_src_dst = concat_src_dst
        self.fc1 = nn.Linear(self.out_dim, 4 * self.out_dim)
        self.fc2 = nn.Linear(4 * self.out_dim, self.out_dim)

    @property
    def dim(self) -> int:
        if not self.use_matrix:
            if self.enforce_dim is not None:
                return self.enforce_dim
            if self.num_edges is not None and self.dim_factor is not None:
                return min(int(math.log(self.num_edges * 2)) * self.dim_factor, self.num_nodes)
            raise ValueError("need enforce_dim or (num_edges, dim_factor) when use_matrix=False")
        return self.num_nodes + 1

    @property
    def out_dim(self) -> int:
        k = 2 * self.num_layer + 2 if self.concat_src_dst else self.num_layer + 1
        return k * k

    def init_state(self, generator: Optional[torch.Generator] = None) -> RandomProjectionState:
        return rp_init_state(self.num_nodes, self.num_layer, self.dim, self.beginning_time,
                             self.use_matrix, generator)

    def update(self, state: RandomProjectionState, src: torch.Tensor, dst: torch.Tensor,
               time: torch.Tensor, valid: Optional[torch.Tensor] = None) -> RandomProjectionState:
        return rp_update(state, src, dst, time, valid, self.time_decay_weight)

    @staticmethod
    def backup_random_projections(state: RandomProjectionState) -> RandomProjectionState:
        return RandomProjectionState(*(x.clone() for x in state))

    @staticmethod
    def reload_random_projections(state: RandomProjectionState) -> RandomProjectionState:
        return state

    def _rows(self, ids: torch.Tensor) -> torch.Tensor:
        n = self.num_nodes
        return torch.where((ids >= 0) & (ids < n), ids, n).long()

    def pair_features(self, state: RandomProjectionState, src: torch.Tensor,
                      dst: torch.Tensor) -> torch.Tensor:
        """The (P, out_dim) inner-product features, before the MLP: per pair,
        the (F, F) products of its stacked (F, dim) projections, F = 2L + 2
        (only the (L+1, L+1) src-dst block without ``concat_src_dst``).

        Only the src-dst block is computed per pair; the src-src and dst-dst
        blocks are computed once per node over the whole state and gathered
        (the JAX package's ``factored_lanes``). On the H100 that is 1.24x
        faster than each pair's whole (F, F) product at the eval call's
        160,000 pairs (``scripts/torch_mixer_ab.py``).
        """
        P = state.projections
        rs, rd = self._rows(src), self._rows(dst)
        a, b = P[:, rs], P[:, rd]  # (L+1, P, dim)
        feat = torch.einsum("lbd,mbd->lmb", a, b)  # (L+1, L+1, P)
        if self.concat_src_dst:
            per_node = torch.einsum("lnd,mnd->lmn", P, P)  # (L+1, L+1, N+1)
            feat = torch.cat([torch.cat([per_node[:, :, rs], feat], dim=1),
                              torch.cat([feat.transpose(0, 1), per_node[:, :, rd]], dim=1)])
        feat = feat.reshape(-1, src.shape[0])
        if self.scale_random_projection:
            feat = torch.log(feat.clamp_min(0.0) + 1.0)
        return feat.T

    def forward(self, state: RandomProjectionState, src: torch.Tensor,
                dst: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.relu(self.fc1(self.pair_features(state, src, dst))))


class TPNet(nn.Module):
    """Neighbour-sequence encoder with random-projection pairwise features.

    ``forward(node_x, edge_src, edge_dst, edge_time, neighbours, neighbours_time,
    neighbours_edge_feat, rp_state=None, deterministic=True, generator=None)``
    takes (2B, K) neighbour rows, the src side first, and returns the (B,
    output_dim) src and dst embeddings. Each neighbour is paired with both
    endpoints of its row's edge: [rp(nbr, src) ‖ rp(nbr, dst)]. Dropout
    runs when the call is not ``deterministic`` and a ``generator`` is
    passed. Padded neighbours' projections are zeroed before the mixers.

    Modules and their JAX names: ``time_encoder``, ``proj_hidden``,
    ``proj_out``, ``mlp_mixers[i]`` (``mlp_mixers_i``) and
    ``random_projections``.
    """

    requires: Set[str] = frozenset({"nbr_nids", "nbr_edge_time", "nbr_edge_x"})

    def __init__(self, node_feat_dim: int, edge_x_dim: int, time_feat_dim: int,
                 output_dim: int, num_neighbors: int, num_layers: int = 2,
                 dropout: float = 0.1,
                 random_projections: Optional[RandomProjectionModule] = None) -> None:
        super().__init__()
        self.num_neighbors = num_neighbors
        self.dropout = dropout
        self.time_encoder = Time2Vec(time_feat_dim)
        self.random_projections = random_projections
        in_dim = node_feat_dim + time_feat_dim + edge_x_dim
        if random_projections is not None:
            in_dim += 2 * random_projections.out_dim
        self.proj_hidden = nn.Linear(in_dim, 2 * output_dim)
        self.proj_out = nn.Linear(2 * output_dim, output_dim)
        self.mlp_mixers = nn.ModuleList([
            MLPMixer(num_neighbors, output_dim, 0.5, 4.0, dropout) for _ in range(num_layers)
        ])

    def forward(self, node_x: torch.Tensor, edge_src: torch.Tensor, edge_dst: torch.Tensor,
                edge_time: torch.Tensor, neighbours: torch.Tensor,
                neighbours_time: torch.Tensor, neighbours_edge_feat: torch.Tensor,
                rp_state: Optional[RandomProjectionState] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        B = edge_src.shape[0]
        K = self.num_neighbors
        pad = (neighbours == PADDED_NODE_ID)[..., None]
        nbr_feat = torch.where(pad, 0.0, node_x[neighbours.clamp_min(0).long()])
        seed_t = torch.cat([edge_time, edge_time])
        # The int32 gap is cast once: casting both times first rounds
        # differently once times pass 2^24.
        dt = torch.log((seed_t[:, None] - neighbours_time).float() + 1.0)
        t_feat = torch.where(pad, 0.0, self.time_encoder(dt))
        parts = [nbr_feat, t_feat, neighbours_edge_feat]
        if self.random_projections is not None:
            if rp_state is None:
                raise ValueError("rp_state is required when random_projections is set")
            nbr_flat = neighbours.reshape(-1)
            src2 = torch.cat([edge_src, edge_src]).repeat_interleave(K)
            dst2 = torch.cat([edge_dst, edge_dst]).repeat_interleave(K)
            f_src = self.random_projections(rp_state, nbr_flat, src2)
            f_dst = self.random_projections(rp_state, nbr_flat, dst2)
            parts.append(torch.cat([f_src, f_dst], dim=1).reshape(2 * B, K, -1))
        h = self.proj_out(torch.relu(self.proj_hidden(torch.cat(parts, dim=2))))
        h = torch.where(pad, 0.0, h)
        gen = None if deterministic else generator
        for mixer in self.mlp_mixers:
            h = mixer(h, gen)
        emb = h.mean(dim=1)
        return emb[:B], emb[B:]


__all__ = [
    "RandomProjectionModule",
    "RandomProjectionState",
    "TPNet",
    "rp_init_state",
    "rp_update",
]
