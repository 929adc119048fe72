"""CTAN (port of ``tgm_tpu/nn/encoder/ctan.py``): non-dissipative temporal
graph propagation over the batch subgraph, and its memory store.

``CTAN`` encodes each node's [memory ‖ static features] with ``enc_x``, then
takes ``num_iters`` antisymmetric steps ``x <- x + eps * tanh(x A^T + phi(x)
+ b)`` with ``A = W - W^T - gamma I``, and returns ``tanh(x)``. ``phi`` is
TransformerConv without a root weight (``_EdgeTransformerConv``); each
edge carries [edge features ‖ Time2Vec(normalised |Δt|)], where Δt is the
int32 gap between the source's last update and the edge's time.

The memory is a store of detached embeddings: ``ctan_memory_update`` writes
each endpoint's embedding from its latest event of the batch (the earliest
position among the rows of the maximum time) and that time, then zeroes the
dump row, the store's last row. Both functions keep the JAX signatures; the
update writes the state in place and returns it.

The neural layers are plain PyTorch (``nn.Linear``, ``ops/segment.py``), as
they are plain XLA in the JAX package. Module names follow flax's:
``time_enc``, ``enc_x``, ``phi`` (its ``lin_edge`` / ``lin_query`` /
``lin_key`` / ``lin_value`` are flax's ``Dense_0`` .. ``Dense_3``), ``W``
and ``b``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ...device import DeviceLike
from ...ops.segment import segment_max, segment_softmax, segment_sum
from ..modules.time_encoding import Time2Vec


class _EdgeTransformerConv(nn.Module):
    """TransformerConv without a root weight (the ``phi`` of AntiSymmetricConv).

    ``e = lin_edge(edge_attr)`` (no bias); keys and values are taken at the
    edge's source plus ``e``; per head, a softmax of ``q[dst] . k`` over each
    target's valid edges, then the weighted sum of the values at the target.
    """

    def __init__(self, in_channels: int, edge_channels: int, out_channels: int,
                 n_heads: int = 1) -> None:
        super().__init__()
        self.out_channels = out_channels
        self.n_heads = n_heads
        self.lin_edge = nn.Linear(edge_channels, out_channels, bias=False)
        self.lin_query = nn.Linear(in_channels, out_channels)
        self.lin_key = nn.Linear(in_channels, out_channels)
        self.lin_value = nn.Linear(in_channels, out_channels)

    def forward(self, x: torch.Tensor, edge_src: torch.Tensor, edge_dst: torch.Tensor,
                edge_attr: torch.Tensor, edge_valid: torch.Tensor) -> torch.Tensor:
        """(U, out_channels); edge ends are clipped into [0, U - 1]."""
        U = x.shape[0]
        H = self.n_heads
        C = self.out_channels // H
        src = edge_src.long().clamp(0, U - 1)
        dst = edge_dst.long().clamp(0, U - 1)
        e = self.lin_edge(edge_attr).reshape(-1, H, C)
        q = self.lin_query(x).reshape(U, H, C)
        k = self.lin_key(x).reshape(U, H, C)[src] + e
        v = self.lin_value(x).reshape(U, H, C)[src] + e
        logits = (q[dst] * k).sum(-1) * (C ** -0.5)  # (E, H)
        alpha = segment_softmax(logits, dst, U, mask=edge_valid)
        out = segment_sum(alpha[..., None] * v, dst, U, mask=edge_valid)
        return out.reshape(U, self.out_channels)


class CTAN(nn.Module):
    """``forward(node_x, last_update, edge_src_local, edge_dst_local, t, msg,
    edge_valid=None) -> (U, memory_dim)``: ``node_x`` is (U, memory_dim +
    node_dim) [memory ‖ static features] of the batch's unique nodes,
    ``last_update`` their (U,) int32 times, and the (E,) local edges carry
    ``msg`` (E, edge_dim) at times ``t``."""

    requires = frozenset({"unique_nids", "global_to_local"})

    def __init__(self, edge_dim: int, memory_dim: int, time_dim: int, node_dim: int,
                 num_iters: int = 1, mean_delta_t: float = 0.0, std_delta_t: float = 1.0,
                 epsilon: float = 0.1, gamma: float = 0.1) -> None:
        super().__init__()
        self.memory_dim = memory_dim
        self.num_iters = num_iters
        self.mean_delta_t = mean_delta_t
        self.std_delta_t = std_delta_t
        self.epsilon = epsilon
        self.gamma = gamma
        self.time_enc = Time2Vec(time_dim)
        self.enc_x = nn.Linear(memory_dim + node_dim, memory_dim)
        self.phi = _EdgeTransformerConv(memory_dim, edge_dim + time_dim, memory_dim)
        self.W = nn.Parameter(torch.empty(memory_dim, memory_dim))
        self.b = nn.Parameter(torch.zeros(memory_dim))
        nn.init.xavier_uniform_(self.W)  # flax's glorot_uniform

    def forward(self, node_x: torch.Tensor, last_update: torch.Tensor,
                edge_src_local: torch.Tensor, edge_dst_local: torch.Tensor, t: torch.Tensor,
                msg: torch.Tensor, edge_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        U = node_x.shape[0]
        if edge_valid is None:
            edge_valid = torch.ones(edge_src_local.shape[0], dtype=torch.bool,
                                    device=node_x.device)
        # The gap is taken in int32 before the cast, as in JAX.
        rel_t = (last_update[edge_src_local.long().clamp(0, U - 1)] - t).abs()
        rel_t = (rel_t.float() - self.mean_delta_t) / self.std_delta_t
        edge_attr = torch.cat([msg, self.time_enc(rel_t)], dim=-1)

        x = self.enc_x(node_x)
        eye = torch.eye(self.memory_dim, device=x.device, dtype=x.dtype)
        A = self.W - self.W.T - self.gamma * eye
        for _ in range(self.num_iters):
            conv = self.phi(x, edge_src_local, edge_dst_local, edge_attr, edge_valid)
            x = x + self.epsilon * torch.tanh(x @ A.T + conv + self.b)
        return torch.tanh(x)


class CTANMemoryState(NamedTuple):
    memory: torch.Tensor  # (N+1, memory_dim) fp32; the last row is the dump row
    last_update: torch.Tensor  # (N+1,) int32


def ctan_memory_init(num_nodes: int, memory_dim: int, init_time: int = 0,
                     device: DeviceLike = "cpu") -> CTANMemoryState:
    """Zero memory and ``init_time`` stamps over N + 1 rows; the last row is
    the dump row."""
    n = num_nodes + 1
    return CTANMemoryState(
        memory=torch.zeros((n, memory_dim), device=device),
        last_update=torch.full((n,), init_time, dtype=torch.int32, device=device),
    )


@torch.no_grad()
def ctan_memory_update(state: CTANMemoryState, src: torch.Tensor, dst: torch.Tensor,
                       t: torch.Tensor, src_emb: torch.Tensor, dst_emb: torch.Tensor,
                       valid: Optional[torch.Tensor] = None) -> CTANMemoryState:
    """Last-by-time write of the batch's endpoint embeddings (detached) and
    times, in place; returns ``state``.

    Each valid node's winner is its row of the maximum time among [src ‖
    dst], the earliest position on a tie. The maxima are ``scatter_reduce``
    (amax, amin) over integers and the winners are unique, so the writes are
    exact and deterministic on every device.
    """
    n = state.memory.shape[0] - 1
    if valid is None:
        valid = torch.ones(src.shape[0], dtype=torch.bool, device=src.device)
    nodes = torch.cat([src, dst])
    tt = torch.cat([t, t])
    emb = torch.cat([src_emb, dst_emb]).detach()
    vv = torch.cat([valid, valid])
    rows = torch.where(vv & (nodes >= 0) & (nodes <= n), nodes, n).long()

    tmax = segment_max(tt, rows, n + 1, mask=vv, initial=-1)
    is_max = vv & (tt == tmax[rows])
    idx = torch.arange(tt.shape[0], device=tt.device)
    first = torch.full((n + 2,), tt.shape[0], dtype=idx.dtype, device=idx.device)
    first.scatter_reduce_(0, torch.where(is_max, rows, n + 1), idx, reduce="amin")
    winner = is_max & (idx == first[rows])
    w_rows = torch.where(winner, rows, n)

    mem, last = state.memory, state.last_update
    mem.index_put_((w_rows,), torch.where(winner[:, None], emb.to(mem.dtype), mem[w_rows]))
    last.index_put_((w_rows,), torch.where(winner, tt.to(last.dtype), last[w_rows]))
    mem[n] = 0.0
    last[n] = 0
    return state


__all__ = ["CTAN", "CTANMemoryState", "ctan_memory_init", "ctan_memory_update"]
