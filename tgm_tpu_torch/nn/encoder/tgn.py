"""TGN memory and rowwise graph attention (port of ``tgm_tpu/nn/encoder/tgn.py``).

* ``TGNMemoryState``: node memory ``mem (N+1, M)``, ``last_update`` and one
  message-store slot per node and role (src->dst, dst->src); row N is the dump
  row. Exact for the LastAggregator, since stores are overwritten per batch.
* ``tgn_store_messages``: per node and role, the earliest batch position
  among the max-time messages wins. The whole store, planned and written,
  is one launch of ``ops.tgn_store_commit``; the state's tensors are
  updated in place.
* ``TGNMemory``: Time2Vec + GRU message update with ``stage`` (train mode
  returns the staged rows, differentiable in the GRU and Time2Vec weights;
  eval mode the stored rows), ``flush``, ``flush_all`` and ``store``.
* ``tgn_commit_staged``: writes staged rows, detached, into the stored
  memory (the train-mode commit of rows the forward already staged).
* ``GraphAttentionEmbeddingRowwise``: each seed attends over its own K
  recent neighbours as dense (S, K) products, with dropout on the attention
  weights drawn from an explicit generator.
* ``rowwise_project_edge_feats``: the message half of its ``lin_edge``
  projection over a whole feature table, for frozen weights (eval), fed
  back per neighbour as ``nbr_msg_proj``.

The mean aggregator, the packed state and the segment
``GraphAttentionEmbedding`` are queued in ROADMAP.md.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ...constants import PADDED_NODE_ID
from ...device import DeviceLike, resolve_device
from ...ops.scatter_cells import tgn_store_commit
from ..modules.dropout import dropout as _dropout
from ..modules.gru import TorchGRUCell
from ..modules.time_encoding import Time2Vec


class TGNMemoryState(NamedTuple):
    """All TGN memory/state tensors; row N is the dump row for padded ids."""

    mem: torch.Tensor  # (N+1, memory_dim) f32
    last_update: torch.Tensor  # (N+1,) int32
    s_other: torch.Tensor  # (N+1,) int32 src-role store: counterpart node
    s_t: torch.Tensor  # (N+1,) int32
    s_raw: torch.Tensor  # (N+1, raw_msg_dim) f32
    s_valid: torch.Tensor  # (N+1,) bool
    d_other: torch.Tensor
    d_t: torch.Tensor
    d_raw: torch.Tensor
    d_valid: torch.Tensor


def tgn_init_state(
    num_nodes: int, memory_dim: int, raw_msg_dim: int, device: DeviceLike = None
) -> TGNMemoryState:
    dev = resolve_device(device)
    n = num_nodes + 1
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    return TGNMemoryState(
        mem=torch.zeros((n, memory_dim), **f32),
        last_update=torch.zeros((n,), **i32),
        s_other=torch.full((n,), PADDED_NODE_ID, **i32),
        s_t=torch.zeros((n,), **i32),
        s_raw=torch.zeros((n, raw_msg_dim), **f32),
        s_valid=torch.zeros((n,), dtype=torch.bool, device=dev),
        d_other=torch.full((n,), PADDED_NODE_ID, **i32),
        d_t=torch.zeros((n,), **i32),
        d_raw=torch.zeros((n, raw_msg_dim), **f32),
        d_valid=torch.zeros((n,), dtype=torch.bool, device=dev),
    )


def _safe_rows(nids: torch.Tensor, n: int) -> torch.Tensor:
    return torch.where((nids >= 0) & (nids < n), nids, n).long()


def tgn_store_messages(
    state: TGNMemoryState,
    src: torch.Tensor,
    dst: torch.Tensor,
    t: torch.Tensor,
    raw_msg: torch.Tensor,
    valid: torch.Tensor,
) -> TGNMemoryState:
    """Overwrite per-node message stores with this batch's events, in place.

    Keeps, per node and role, the earliest-position message among those with
    the maximum timestamp (the LastAggregator's choice). ``src``, ``dst``,
    ``t`` are (E,) int32, ``raw_msg`` (E, R) float32, ``valid`` (E,) bool;
    the dump row is left as it was (see ``ops.tgn_store_commit``).
    """
    return tgn_store_commit(state, src, dst, t, raw_msg, valid)


class TGNMemory(nn.Module):
    """Learnable part of the TGN memory: Time2Vec + GRU message update.

    LastAggregator only (``aggregator='mean'`` is queued in ROADMAP.md).
    """

    def __init__(
        self,
        num_nodes: int,
        raw_msg_dim: int,
        memory_dim: int,
        time_dim: int,
        aggregator: str = "last",
    ) -> None:
        super().__init__()
        if aggregator != "last":
            raise NotImplementedError(
                f"aggregator={aggregator!r}: only 'last' is ported (see ROADMAP.md)"
            )
        self.num_nodes = num_nodes
        self.raw_msg_dim = raw_msg_dim
        self.memory_dim = memory_dim
        self.time_dim = time_dim
        self.time_enc = Time2Vec(time_dim)
        self.gru = TorchGRUCell(2 * memory_dim + raw_msg_dim + time_dim, memory_dim)

    def init_state(self, device: DeviceLike = None) -> TGNMemoryState:
        return tgn_init_state(self.num_nodes, self.memory_dim, self.raw_msg_dim, device)

    def _staged(
        self, state: TGNMemoryState, nids: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Updated (memory, last_update) rows for ``nids`` from pending messages.

        Message = [mem[n] | mem[other] | raw | enc(t - last_update[n])] of the
        LastAggregator winner across the two role stores (src role wins ties);
        the GRU runs on every row (zero message when none is pending);
        last_update = the winner's time (0 if none).
        """
        n = state.mem.shape[0] - 1
        rows = _safe_rows(nids, n)
        last_upd = state.last_update[rows]
        s_t, v_s = state.s_t[rows], state.s_valid[rows]
        d_t, v_d = state.d_t[rows], state.d_valid[rows]
        t_s_eff = torch.where(v_s, s_t, -1)
        t_d_eff = torch.where(v_d, d_t, -1)
        use_d = t_d_eff > t_s_eff
        any_valid = v_s | v_d

        other_w = torch.where(use_d, state.d_other[rows], state.s_other[rows])
        t_w = torch.where(use_d, d_t, s_t)
        mem_rows = state.mem[rows]
        mem_other = state.mem[other_w.clamp(0, n).long()]
        raw_w = torch.where(use_d[:, None], state.d_raw[rows], state.s_raw[rows])
        enc = self.time_enc((t_w - last_upd).float())

        agg = torch.cat([mem_rows, mem_other, raw_w, enc], dim=-1)
        agg = torch.where(any_valid[:, None], agg, 0.0)
        new_mem, _ = self.gru(mem_rows, agg)
        new_last = torch.clamp_min(torch.maximum(t_s_eff, t_d_eff), 0).int()
        return new_mem, new_last

    def stage(self, state: TGNMemoryState, nids: torch.Tensor, training: bool = True):
        """Staged memory in train mode, stored memory in eval mode."""
        if training:
            return self._staged(state, nids)
        rows = _safe_rows(nids, state.mem.shape[0] - 1)
        return state.mem[rows], state.last_update[rows]

    def flush(self, state: TGNMemoryState, nids: torch.Tensor) -> TGNMemoryState:
        """Apply pending messages for ``nids`` into stored memory, in place."""
        with torch.no_grad():
            new_mem, new_last = self._staged(state, nids)
        return tgn_commit_staged(state, nids, new_mem, new_last)

    def flush_all(self, state: TGNMemoryState) -> TGNMemoryState:
        """Train->eval transition: flush every node, clear the stores."""
        nodes = torch.arange(self.num_nodes, dtype=torch.int32, device=state.mem.device)
        state = self.flush(state, nodes)
        for name in ("s_other", "d_other"):
            getattr(state, name).fill_(PADDED_NODE_ID)
        for name in ("s_t", "s_raw", "s_valid", "d_t", "d_raw", "d_valid"):
            getattr(state, name).zero_()
        return state

    def forward(self, state: TGNMemoryState, nids: torch.Tensor):
        return self.stage(state, nids, training=True)

    def store(self, state: TGNMemoryState, src: torch.Tensor, dst: torch.Tensor,
              t: torch.Tensor, raw_msg: torch.Tensor, valid: torch.Tensor) -> TGNMemoryState:
        """Message-store write of a batch, in place (LastAggregator)."""
        return tgn_store_messages(state, src, dst, t, raw_msg, valid)


def tgn_commit_staged(state: TGNMemoryState, nodes: torch.Tensor, st_mem: torch.Tensor,
                      st_last: torch.Tensor) -> TGNMemoryState:
    """Write staged (memory, last_update) rows for ``nodes`` into the stored
    state, in place, then reset the dump row.

    The flush-equivalent commit for callers that staged ``nodes`` in their
    forward: a staged row is a per-row function of the pre-commit state, so
    duplicate ids carry equal rows and the write order does not matter.
    Invalid or out-of-range ids go to the dump row. ``st_mem`` is detached.
    """
    n = state.mem.shape[0] - 1
    rows = _safe_rows(nodes, n)
    with torch.no_grad():
        state.mem.index_put_((rows,), st_mem.detach().to(state.mem.dtype))
        state.mem[n] = 0.0
        state.last_update.index_put_((rows,), st_last.to(state.last_update.dtype))
        state.last_update[n] = 0
    return state


class GraphAttentionEmbeddingRowwise(nn.Module):
    """Dense per-seed attention over each seed's K recent neighbours.

    Query = seed memory; keys/values = neighbour memory plus a projection of
    [Time2Vec(relative time) | edge message]. Scores are laid out (S, K, H)
    (the JAX ``kmajor`` layout; its ``lanesv`` layout is the same math with
    seeds on the TPU lanes). Dropout on the attention weights (after the
    mask: keep with probability 1 - p, scale by 1 / (1 - p)) is drawn from the
    ``generator`` passed to ``forward``, and only when one is passed and p >
    0, so a train run is reproducible from its seed and a call without a
    generator is deterministic whatever the module's train/eval mode.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        msg_dim: int,
        time_dim: int,
        n_heads: int = 2,
        dropout: float = 0.1,
    ) -> None:
        super().__init__()
        if out_channels % n_heads:
            raise ValueError(f"out_channels {out_channels} not divisible by n_heads {n_heads}")
        self.out_channels = out_channels
        self.n_heads = n_heads
        self.head_dim = out_channels // n_heads
        self.time_enc = Time2Vec(time_dim)
        self.lin_query = nn.Linear(in_channels, out_channels)
        self.lin_key = nn.Linear(in_channels, out_channels)
        self.lin_value = nn.Linear(in_channels, out_channels)
        self.lin_edge = nn.Linear(time_dim + msg_dim, out_channels, bias=False)
        self.lin_skip = nn.Linear(in_channels, out_channels)
        self.dropout = dropout

    def forward(
        self,
        x_seed: torch.Tensor,  # (S, in_channels) seed memory rows
        x_nbr: torch.Tensor,  # (S, K, in_channels) neighbour memory rows
        seed_last_update: torch.Tensor,  # (S,)
        nbr_time: torch.Tensor,  # (S, K)
        nbr_msg: torch.Tensor,  # (S, K, msg_dim)
        nbr_valid: torch.Tensor,  # (S, K) bool
        generator: Optional[torch.Generator] = None,
        nbr_msg_proj: Optional[torch.Tensor] = None,  # (S, K, out_channels) msg @ W_m^T
    ) -> torch.Tensor:
        """The edge projection ``lin_edge([time_feat | msg])`` is computed as
        the split sum ``time_feat @ W_t^T + msg @ W_m^T`` (XLA splits the JAX
        dense over the concat the same way). With ``nbr_msg_proj`` (rows of
        ``rowwise_project_edge_feats``) the message half is given and
        ``nbr_msg`` is not read: where the matmul rounds each row alike
        whatever the row count, as it does on the CPU and the H100, the
        pre-projected table changes no bit of the result."""
        S, K = nbr_valid.shape
        H, C = self.n_heads, self.head_dim
        rel_t = seed_last_update[:, None] - nbr_time
        time_feat = self.time_enc(rel_t.float()).reshape(S * K, -1)
        T = time_feat.shape[1]
        if nbr_msg_proj is None:
            nbr_msg_proj = nbr_msg.reshape(S * K, -1) @ self.lin_edge.weight[:, T:].T
        e_t = time_feat @ self.lin_edge.weight[:, :T].T
        e = (e_t + nbr_msg_proj.reshape(S * K, -1)).reshape(S, K, H, C)

        q = self.lin_query(x_seed).reshape(S, H, C)
        xn2 = x_nbr.reshape(S * K, -1)
        k = self.lin_key(xn2).reshape(S, K, H, C) + e
        v = self.lin_value(xn2).reshape(S, K, H, C) + e

        mask = nbr_valid[:, :, None]
        logits = torch.einsum("shc,skhc->skh", q, k) * (C ** -0.5)
        logits = torch.where(mask, logits, -1e10)
        alpha = torch.softmax(logits, dim=1)
        alpha = _dropout(torch.where(mask, alpha, 0.0), self.dropout, generator)
        out = torch.einsum("skh,skhc->shc", alpha, v).reshape(S, self.out_channels)
        return out + self.lin_skip(x_seed)


def rowwise_project_edge_feats(encoder: GraphAttentionEmbeddingRowwise,
                               edge_x_full: torch.Tensor) -> torch.Tensor:
    """``edge_x_full @ W_m^T``: the message half of ``encoder.lin_edge`` over
    a static (E, msg_dim) feature table, (E, out_channels).

    Valid while the weights are frozen (eval): computed once, its rows stand
    in for the per-batch message projection (``nbr_msg_proj``). Zero rows
    project to zero (``lin_edge`` has no bias), so padding stays zero.
    """
    T = encoder.lin_edge.in_features - edge_x_full.shape[1]
    with torch.no_grad():
        return edge_x_full @ encoder.lin_edge.weight[:, T:].T


__all__ = [
    "GraphAttentionEmbeddingRowwise",
    "TGNMemory",
    "TGNMemoryState",
    "tgn_commit_staged",
    "tgn_init_state",
    "rowwise_project_edge_feats",
    "tgn_store_messages",
]
