"""TGN memory and graph attention (port of ``tgm_tpu/nn/encoder/tgn.py``).

* ``TGNMemoryState``: node memory ``mem (N+1, M)``, ``last_update`` and one
  message-store slot per node and role (src->dst, dst->src); row N is the dump
  row. Exact for the LastAggregator, since stores are overwritten per batch.
* ``tgn_store_messages``: per node and role, the earliest batch position
  among the max-time messages wins. The whole store, planned and written,
  is one launch of ``ops.tgn_store_commit``; the state's tensors are
  updated in place.
* ``TGNPackedState`` (``tgn_pack_state``, ``tgn_unpack_state``,
  ``tgn_store_messages_packed``): the same state with the scalar fields in
  one (N+1, 8) int32 matrix and both roles' raw messages in one (N+1, 2R)
  matrix. Its store is PyTorch scatters (the JAX one is jnp, not Pallas).
* ``TGNMeanMemoryState`` (``tgn_mean_init_state``,
  ``tgn_mean_store_messages``): the mean aggregator's multi-slot ring of
  each node's messages from the latest batch that touched it, keep-last
  ``mean_slots``, with an ``overflow`` count of the messages dropped.
* ``TGNMemory``: Time2Vec + GRU message update with ``stage`` (train mode
  returns the staged rows, differentiable in the GRU and Time2Vec weights;
  eval mode the stored rows), ``flush``, ``flush_all`` and ``store``, for
  all three state layouts (``aggregator="mean"`` takes the mean state);
  ``stage_rows`` stages rows gathered elsewhere (``pending_rows``), as the
  node-sharded step does with rows fetched from their owners.
* ``tgn_commit_staged``: writes staged rows, detached, into the stored
  memory (the train-mode commit of rows the forward already staged).
* ``GraphAttentionEmbedding``: TransformerConv over a deduplicated batch
  subgraph, segment softmax and segment sum at the neighbour rows.
* ``GraphAttentionEmbeddingRowwise``: each seed attends over its own K
  recent neighbours as dense (S, K) products.
* ``rowwise_project_edge_feats``: the message half of the ``lin_edge``
  projection over a whole feature table, for frozen weights (eval), fed
  back per neighbour as ``nbr_msg_proj`` (bf16 with ``kv_bf16``).

Both encoders draw dropout on the attention weights from an explicit
generator, and share their parameters' names with the flax modules.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ...constants import PADDED_NODE_ID
from ...device import DeviceLike, resolve_device
from ...ops.scatter_cells import put_live, store_winners, tgn_store_commit
from ...ops.segment import segment_softmax, segment_sum
from ..modules.bf16 import BF16, dense, einsum_f32
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


class TGNPackedState(NamedTuple):
    """``TGNMemoryState`` with its fields gathered into three tensors.

    meta columns: [last_update, s_other, s_t, s_valid, d_other, d_t, d_valid, 0]
    raws columns: [s_raw (R) | d_raw (R)]
    """

    mem: torch.Tensor  # (N+1, M) f32
    raws: torch.Tensor  # (N+1, 2R) f32
    meta: torch.Tensor  # (N+1, 8) int32


_DUMP_META = (0, PADDED_NODE_ID, 0, 0, PADDED_NODE_ID, 0, 0, 0)


def tgn_pack_state(s: TGNMemoryState) -> TGNPackedState:
    meta = torch.stack([s.last_update, s.s_other, s.s_t, s.s_valid.int(), s.d_other, s.d_t,
                        s.d_valid.int(), torch.zeros_like(s.last_update)], dim=1)
    return TGNPackedState(mem=s.mem.clone(), raws=torch.cat([s.s_raw, s.d_raw], dim=1), meta=meta)


def tgn_unpack_state(p: TGNPackedState) -> TGNMemoryState:
    """The unpacked state, as contiguous copies."""
    R = p.raws.shape[1] // 2
    m = p.meta
    col = lambda i: m[:, i].contiguous()
    return TGNMemoryState(
        mem=p.mem.clone(), last_update=col(0),
        s_other=col(1), s_t=col(2), s_raw=p.raws[:, :R].contiguous(), s_valid=m[:, 3].bool(),
        d_other=col(4), d_t=col(5), d_raw=p.raws[:, R:].contiguous(), d_valid=m[:, 6].bool(),
    )


def tgn_store_messages_packed(
    state: TGNPackedState,
    src: torch.Tensor,
    dst: torch.Tensor,
    t: torch.Tensor,
    raw_msg: torch.Tensor,
    valid: torch.Tensor,
) -> TGNPackedState:
    """``tgn_store_messages`` on the packed layout, in place: the same
    winners, then one meta and one raws scatter per role; the dump row is
    reset."""
    N1 = state.mem.shape[0]
    R = state.raws.shape[1] // 2
    for owner, other, mcol, rcol in ((src, dst, 1, 0), (dst, src, 4, R)):
        winner, rows = store_winners(owner, t, valid, N1)
        cols = torch.stack([other, t, torch.ones_like(t)], dim=1).to(state.meta.dtype)
        put_live(state.meta[:, mcol : mcol + 3], (rows,), winner, cols)
        put_live(state.raws[:, rcol : rcol + R], (rows,), winner, raw_msg)
    state.meta[N1 - 1] = torch.tensor(_DUMP_META, dtype=state.meta.dtype,
                                      device=state.meta.device)
    state.raws[N1 - 1] = 0.0
    return state


class TGNMeanMemoryState(NamedTuple):
    """Mean-aggregator state: per role, a ring of ``mean_slots`` message slots a node.

    A slot is live while its ``*_stamp`` equals the node's ``*_latest``
    batch counter: older entries are ignored at read time, which is the
    reference's per-batch store overwrite. Exact up to ``mean_slots``
    messages a node, role and batch; past that the latest are kept and
    ``overflow`` counts the rest.
    """

    mem: torch.Tensor  # (N+1, memory_dim)
    last_update: torch.Tensor  # (N+1,)
    s_other: torch.Tensor  # (N+1, K)
    s_t: torch.Tensor  # (N+1, K)
    s_raw: torch.Tensor  # (N+1, K, raw_msg_dim)
    s_stamp: torch.Tensor  # (N+1, K) batch counter of each slot (0 = empty)
    s_wp: torch.Tensor  # (N+1,) next slot
    s_latest: torch.Tensor  # (N+1,) counter of the latest batch that wrote the node
    d_other: torch.Tensor
    d_t: torch.Tensor
    d_raw: torch.Tensor
    d_stamp: torch.Tensor
    d_wp: torch.Tensor
    d_latest: torch.Tensor
    counter: torch.Tensor  # () batch counter
    overflow: torch.Tensor  # () messages dropped by the slot limit, cumulative


def tgn_mean_init_state(num_nodes: int, memory_dim: int, raw_msg_dim: int, mean_slots: int = 8,
                        device: DeviceLike = None) -> TGNMeanMemoryState:
    dev = resolve_device(device)
    n = num_nodes + 1
    i32 = dict(dtype=torch.int32, device=dev)

    def role():
        return (torch.full((n, mean_slots), PADDED_NODE_ID, **i32),
                torch.zeros((n, mean_slots), **i32),
                torch.zeros((n, mean_slots, raw_msg_dim), device=dev),
                torch.zeros((n, mean_slots), **i32),
                torch.zeros((n,), **i32),
                torch.zeros((n,), **i32))

    s, d = role(), role()
    return TGNMeanMemoryState(
        torch.zeros((n, memory_dim), device=dev), torch.zeros((n,), **i32),
        *s, *d, torch.zeros((), **i32), torch.zeros((), **i32),
    )


def tgn_mean_store_messages(
    state: TGNMeanMemoryState,
    src: torch.Tensor,
    dst: torch.Tensor,
    t: torch.Tensor,
    raw_msg: torch.Tensor,
    valid: torch.Tensor,
) -> TGNMeanMemoryState:
    """Write a batch's events into the per-role rings, in place, under a new
    batch stamp: in a stable (node, time) order each node keeps its last
    ``mean_slots`` events; the slots continue at the node's write position.
    Valid events whose owner lies outside [0, N - 1] are not written."""
    n = state.mem.shape[0] - 1
    counter = state.counter + 1
    E = t.shape[0]
    idx = torch.arange(E, device=t.device)

    def write(owner, other, o_buf, t_buf, r_buf, st_buf, wp, latest):
        K = o_buf.shape[1]
        rows_in = torch.where(valid & (owner >= 0) & (owner < n), owner, n).long()
        p1 = torch.sort(t, stable=True).indices
        perm = p1[torch.sort(rows_in[p1], stable=True).indices]
        nodes = rows_in[perm]
        is_start = torch.ones(E, dtype=torch.bool, device=t.device)
        is_start[1:] = nodes[1:] != nodes[:-1]
        group_start = torch.cummax(torch.where(is_start, idx, -1), 0).values
        pos = idx - group_start
        cnt = torch.zeros(n + 1, dtype=torch.long, device=t.device).index_add_(
            0, nodes, torch.ones_like(nodes))[nodes]
        live = nodes < n
        keep = (pos >= cnt - K) & live
        dropped = ((pos < cnt - K) & live).sum()
        col = (wp[nodes] + pos - (cnt - K).clamp_min(0)) % K
        for buf, val in ((o_buf, other[perm]), (t_buf, t[perm]), (r_buf, raw_msg[perm]),
                         (st_buf, counter.expand(E))):
            put_live(buf, (nodes, col), keep, val.to(buf.dtype))
        o_buf[n] = PADDED_NODE_ID
        for buf in (t_buf, r_buf, st_buf):
            buf[n] = 0
        bump = torch.zeros(n + 1, dtype=wp.dtype, device=t.device).index_add_(
            0, torch.where(keep, nodes, n), keep.to(wp.dtype))
        wp.copy_((wp + bump) % K)
        wp[n] = 0
        latest.copy_(torch.where(bump > 0, counter, latest))
        latest[n] = 0
        return dropped

    dropped = write(src, dst, state.s_other, state.s_t, state.s_raw, state.s_stamp,
                    state.s_wp, state.s_latest)
    dropped = dropped + write(dst, src, state.d_other, state.d_t, state.d_raw, state.d_stamp,
                              state.d_wp, state.d_latest)
    state.counter.copy_(counter)
    state.overflow.add_(dropped.to(state.overflow.dtype))
    return state


def pending_rows(state, rows: torch.Tensor):
    """The scalar and raw message-store fields of ``rows`` (in range, dump
    row included) of an unpacked or packed state: ``(last_update, s_other,
    s_t, s_valid, s_raw, d_other, d_t, d_valid, d_raw)``."""
    if isinstance(state, TGNPackedState):
        meta, raws = state.meta[rows], state.raws[rows]
        R = raws.shape[1] // 2
        return (meta[:, 0], meta[:, 1], meta[:, 2], meta[:, 3].bool(), raws[:, :R],
                meta[:, 4], meta[:, 5], meta[:, 6].bool(), raws[:, R:])
    return (state.last_update[rows], state.s_other[rows], state.s_t[rows], state.s_valid[rows],
            state.s_raw[rows], state.d_other[rows], state.d_t[rows], state.d_valid[rows],
            state.d_raw[rows])


class TGNMemory(nn.Module):
    """Learnable part of the TGN memory: Time2Vec + GRU message update.

    ``aggregator="last"`` (exact single-slot stores, ``TGNMemoryState`` or
    its packed layout) or ``"mean"`` (``TGNMeanMemoryState``: the mean of
    each node's messages from its latest batch, exact up to ``mean_slots``
    messages a node, role and batch).
    """

    def __init__(
        self,
        num_nodes: int,
        raw_msg_dim: int,
        memory_dim: int,
        time_dim: int,
        aggregator: str = "last",
        mean_slots: int = 8,
    ) -> None:
        super().__init__()
        if aggregator not in ("last", "mean"):
            raise ValueError(f"Unknown aggregator {aggregator!r}")
        self.num_nodes = num_nodes
        self.raw_msg_dim = raw_msg_dim
        self.memory_dim = memory_dim
        self.time_dim = time_dim
        self.aggregator = aggregator
        self.mean_slots = mean_slots
        self.time_enc = Time2Vec(time_dim)
        self.gru = TorchGRUCell(2 * memory_dim + raw_msg_dim + time_dim, memory_dim)

    def init_state(self, device: DeviceLike = None):
        if self.aggregator == "mean":
            return tgn_mean_init_state(self.num_nodes, self.memory_dim, self.raw_msg_dim,
                                       self.mean_slots, device)
        return tgn_init_state(self.num_nodes, self.memory_dim, self.raw_msg_dim, device)

    def _staged(self, state, nids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Updated (memory, last_update) rows for ``nids`` from pending messages
        (``stage_rows`` over the state's own rows)."""
        if self.aggregator == "mean":
            return self._staged_mean(state, nids)
        n = state.mem.shape[0] - 1
        rows = _safe_rows(nids, n)
        return self.stage_rows(state.mem[rows], pending_rows(state, rows),
                               lambda other: state.mem[other.clamp(0, n).long()])

    def stage_rows(self, mem_rows: torch.Tensor, pending, mem_of) -> Tuple[torch.Tensor,
                                                                          torch.Tensor]:
        """The LastAggregator's staged rows from gathered ones: ``mem_rows``
        and ``pending`` (``pending_rows``) of the same rows, and ``mem_of(ids)``,
        the stored memory of the winners' counterparts (PAD where there is
        none; the local version reads row 0 for it, ``clamp(0, N)``).

        Message = [mem[n] | mem[other] | raw | enc(t - last_update[n])] of the
        winner across the two role stores (src role wins ties); the GRU runs
        on every row (zero message when none is pending); last_update = the
        winner's time (0 if none). The winner is chosen from the scalar
        fields first, so only its role's row is gathered and encoded.
        """
        last_upd, s_other, s_t, v_s, s_raw, d_other, d_t, v_d, d_raw = pending
        t_s_eff = torch.where(v_s, s_t, -1)
        t_d_eff = torch.where(v_d, d_t, -1)
        use_d = t_d_eff > t_s_eff
        any_valid = v_s | v_d

        other_w = torch.where(use_d, d_other, s_other)
        t_w = torch.where(use_d, d_t, s_t)
        mem_other = mem_of(other_w)
        raw_w = torch.where(use_d[:, None], d_raw, s_raw)
        enc = self.time_enc((t_w - last_upd).float())

        agg = torch.cat([mem_rows, mem_other, raw_w, enc], dim=-1)
        agg = torch.where(any_valid[:, None], agg, 0.0)
        new_mem, _ = self.gru(mem_rows, agg)
        new_last = torch.clamp_min(torch.maximum(t_s_eff, t_d_eff), 0).int()
        return new_mem, new_last

    def _staged_mean(self, state: TGNMeanMemoryState, nids: torch.Tensor):
        """Mean over each node's live messages of both roles; the GRU runs on
        every row (zero message when none); last_update = the latest live
        message's time (0 if none)."""
        n = state.mem.shape[0] - 1
        rows = _safe_rows(nids, n)
        mem_rows = state.mem[rows]
        last_upd = state.last_update[rows]

        def role(other, t, raw, stamp, latest):
            o = other[rows]  # (S, K)
            tt = t[rows]
            lat = latest[rows]
            alive = (stamp[rows] == lat[:, None]) & (lat > 0)[:, None] & (o != PADDED_NODE_ID)
            enc = self.time_enc((tt - last_upd[:, None]).float())  # (S, K, T)
            msg = torch.cat([mem_rows[:, None, :].expand(-1, o.shape[1], -1),
                             state.mem[o.clamp(0, n).long()], raw[rows], enc], dim=-1)
            w = alive.to(msg.dtype)
            return (msg * w[..., None]).sum(1), w.sum(1), torch.where(alive, tt, 0).amax(1)

        sum_s, cnt_s, tmax_s = role(state.s_other, state.s_t, state.s_raw, state.s_stamp,
                                    state.s_latest)
        sum_d, cnt_d, tmax_d = role(state.d_other, state.d_t, state.d_raw, state.d_stamp,
                                    state.d_latest)
        aggr = (sum_s + sum_d) / (cnt_s + cnt_d).clamp_min(1.0)[:, None]
        new_mem, _ = self.gru(mem_rows, aggr)
        return new_mem, torch.maximum(tmax_s, tmax_d).int()

    def stage(self, state, nids: torch.Tensor, training: bool = True):
        """Staged memory in train mode, stored memory in eval mode."""
        if training:
            return self._staged(state, nids)
        rows = _safe_rows(nids, state.mem.shape[0] - 1)
        if isinstance(state, TGNPackedState):
            return state.mem[rows], state.meta[rows, 0]
        return state.mem[rows], state.last_update[rows]

    def flush(self, state, nids: torch.Tensor):
        """Apply pending messages for ``nids`` into stored memory, in place."""
        with torch.no_grad():
            new_mem, new_last = self._staged(state, nids)
        return tgn_commit_staged(state, nids, new_mem, new_last)

    def flush_all(self, state):
        """Train->eval transition: flush every node, clear the stores."""
        nodes = torch.arange(self.num_nodes, dtype=torch.int32, device=state.mem.device)
        state = self.flush(state, nodes)
        if isinstance(state, TGNMeanMemoryState):
            # A zero latest stamp marks every slot stale: the stores are reset.
            state.s_latest.zero_()
            state.d_latest.zero_()
        elif isinstance(state, TGNPackedState):
            state.meta[:, 1:] = torch.tensor(_DUMP_META[1:], dtype=state.meta.dtype,
                                             device=state.meta.device)
            state.raws.zero_()
        else:
            for name in ("s_other", "d_other"):
                getattr(state, name).fill_(PADDED_NODE_ID)
            for name in ("s_t", "s_raw", "s_valid", "d_t", "d_raw", "d_valid"):
                getattr(state, name).zero_()
        return state

    # The JAX method names of the packed layout; the methods above take it too.
    stage_packed = stage
    flush_packed = flush
    flush_all_packed = flush_all

    def forward(self, state, nids: torch.Tensor):
        return self.stage(state, nids, training=True)

    def store(self, state, src: torch.Tensor, dst: torch.Tensor, t: torch.Tensor,
              raw_msg: torch.Tensor, valid: torch.Tensor):
        """Message-store write of a batch, in place: by the aggregator, then
        by the state's layout."""
        if self.aggregator == "mean":
            return tgn_mean_store_messages(state, src, dst, t, raw_msg, valid)
        if isinstance(state, TGNPackedState):
            return tgn_store_messages_packed(state, src, dst, t, raw_msg, valid)
        return tgn_store_messages(state, src, dst, t, raw_msg, valid)


def tgn_commit_staged(state, nodes: torch.Tensor, st_mem: torch.Tensor,
                      st_last: torch.Tensor) -> TGNMemoryState:
    """Write staged (memory, last_update) rows for ``nodes`` into the stored
    state, in place, then reset the dump row.

    The flush-equivalent commit for callers that staged ``nodes`` in their
    forward: a staged row is a per-row function of the pre-commit state, so
    duplicate ids carry equal rows and the write order does not matter.
    Invalid or out-of-range ids go to the dump row. ``st_mem`` is detached.
    Takes each state layout: the packed one keeps ``last_update`` in
    ``meta[:, 0]``.
    """
    n = state.mem.shape[0] - 1
    rows = _safe_rows(nodes, n)
    last = state.meta[:, 0] if isinstance(state, TGNPackedState) else state.last_update
    with torch.no_grad():
        state.mem.index_put_((rows,), st_mem.detach().to(state.mem.dtype))
        state.mem[n] = 0.0
        last.index_put_((rows,), st_last.to(last.dtype))
        last[n] = 0
    return state


class _TransformerConvWeights(nn.Module):
    """The parameters both TGN encoders share, under the flax names: Time2Vec
    ``time_enc``, ``lin_query``, ``lin_key``, ``lin_value``, ``lin_edge`` (no
    bias) over [Time2Vec(relative time) | edge message], and ``lin_skip``.
    ``dropout`` is the rate of the attention weights' dropout."""

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

    def edge_projection(self, time_feat: torch.Tensor, msg: torch.Tensor,
                        msg_proj: Optional[torch.Tensor] = None,
                        dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """``lin_edge([time_feat | msg])`` of (R, T) and (R, msg_dim) rows as
        the split sum ``time_feat @ W_t^T + msg @ W_m^T`` (XLA splits the JAX
        dense over the concat the same way; a bf16 ``msg`` promotes to fp32);
        ``msg_proj`` gives the message half and ``msg`` is not read.

        ``dtype=bf16`` is ``lin_edge`` as a bf16 dense: the fp32-accumulated
        sum over both halves rounded once; with ``msg_proj`` the JAX
        pre-projected form, the time half rounded, then added to the bf16
        ``msg_proj`` in bf16."""
        T = time_feat.shape[1]
        w_t, w_m = self.lin_edge.weight[:, :T], self.lin_edge.weight[:, T:]
        if dtype is not None:
            w_t = w_t.to(dtype).float()
            e_t = time_feat.to(dtype).float() @ w_t.T
            if msg_proj is None:
                return (e_t + msg.to(dtype).float() @ w_m.to(dtype).float().T).to(dtype)
            return e_t.to(dtype) + msg_proj.to(dtype)
        if msg_proj is None:
            msg_proj = msg.float() @ w_m.T
        return time_feat @ w_t.T + msg_proj


class GraphAttentionEmbedding(_TransformerConvWeights):
    """TransformerConv over a batch subgraph with relative-time edge features.

    The reference example's formulation (PyG ``TransformerConv``, heads of
    out/heads channels, dropout on the attention weights, root weight,
    heads concatenated) as gather + segment softmax over the padded local
    edge list: edge e carries the message of node ``edge_src_local[e]`` to
    node ``edge_dst_local[e]`` (the example stacks [seed, neighbour], so the
    seeds' keys and values aggregate at the neighbours' rows). Dropout is
    drawn from the ``generator`` passed to ``forward``, and only when one is
    passed and p > 0.
    """

    def forward(
        self,
        x: torch.Tensor,  # (U, in_channels) node (memory) rows
        last_update: torch.Tensor,  # (U,)
        edge_src_local: torch.Tensor,  # (E,) local source (seed) rows
        edge_dst_local: torch.Tensor,  # (E,) local target (neighbour) rows
        edge_time: torch.Tensor,  # (E,)
        edge_msg: torch.Tensor,  # (E, msg_dim)
        edge_valid: torch.Tensor,  # (E,) bool
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """(U, out_channels): per head, the softmax of q[dst] . k over each
        target's valid edges, the weighted sum of v at the target, plus
        ``lin_skip(x)``. Edge rows are clipped into [0, U - 1]."""
        U = x.shape[0]
        H, C = self.n_heads, self.head_dim
        src = edge_src_local.long().clamp(0, U - 1)
        dst = edge_dst_local.long().clamp(0, U - 1)
        rel_t = last_update[src] - edge_time
        e = self.edge_projection(self.time_enc(rel_t.float()), edge_msg).reshape(-1, H, C)
        q = self.lin_query(x).reshape(U, H, C)
        k = self.lin_key(x).reshape(U, H, C)[src] + e
        v = self.lin_value(x).reshape(U, H, C)[src] + e
        logits = (q[dst] * k).sum(-1) * (C ** -0.5)  # (E, H)
        alpha = segment_softmax(logits, dst, U, mask=edge_valid)
        alpha = _dropout(alpha, self.dropout, generator)
        out = segment_sum(alpha[..., None] * v, dst, U, mask=edge_valid)  # (U, H, C)
        return out.reshape(U, self.out_channels) + self.lin_skip(x)


class GraphAttentionEmbeddingRowwise(_TransformerConvWeights):
    """Dense per-seed attention over each seed's K recent neighbours.

    Query = seed memory; keys/values = neighbour memory plus a projection of
    [Time2Vec(relative time) | edge message]. Scores are laid out (S, K, H)
    (the JAX ``kmajor`` layout; its ``lanesv`` layout is the same math with
    seeds on the TPU lanes). Dropout on the attention weights (after the
    mask: keep with probability 1 - p, scale by 1 / (1 - p)) is drawn from the
    ``generator`` passed to ``forward``, and only when one is passed and p >
    0, so a train run is reproducible from its seed and a call without a
    generator is deterministic whatever the module's train/eval mode.

    ``kv_bf16=True`` is the JAX bf16 K/V path, rounding where flax rounds
    (``nn/modules/bf16.py``): the time features, the messages and the
    neighbour memory are cast to bf16; ``lin_key``, ``lin_value`` and
    ``lin_edge`` are bf16 denses (product rounded, then the bias added in
    bf16); ``k = key + e`` and ``v = value + e`` are bf16 adds; q (fp32
    ``lin_query``) is cast to bf16; scores and the value product are fp32
    sums of bf16 products; the softmax and ``lin_skip`` stay fp32.
    """

    def __init__(self, in_channels: int, out_channels: int, msg_dim: int, time_dim: int,
                 n_heads: int = 2, dropout: float = 0.1, kv_bf16: bool = False) -> None:
        super().__init__(in_channels, out_channels, msg_dim, time_dim, n_heads, dropout)
        self.kv_bf16 = kv_bf16

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
        """With ``nbr_msg_proj`` (rows of ``rowwise_project_edge_feats``) the
        message half of the edge projection is given and ``nbr_msg`` is not
        read: where the matmul rounds each row alike whatever the row count,
        as it does on the CPU and the H100, the pre-projected table changes
        no bit of the result."""
        S, K = nbr_valid.shape
        H, C = self.n_heads, self.head_dim
        dt = BF16 if self.kv_bf16 else None
        rel_t = seed_last_update[:, None] - nbr_time
        time_feat = self.time_enc(rel_t.float()).reshape(S * K, -1)
        e = self.edge_projection(
            time_feat, nbr_msg.reshape(S * K, -1),
            None if nbr_msg_proj is None else nbr_msg_proj.reshape(S * K, -1), dt,
        ).reshape(S, K, H, C)

        q = self.lin_query(x_seed).reshape(S, H, C)
        xn2 = x_nbr.reshape(S * K, -1)
        k = dense(xn2, self.lin_key, dt).reshape(S, K, H, C) + e
        v = dense(xn2, self.lin_value, dt).reshape(S, K, H, C) + e

        mask = nbr_valid[:, :, None]
        logits = einsum_f32("shc,skhc->skh", q.to(k.dtype), k) * (C ** -0.5)
        logits = torch.where(mask, logits, -1e10)
        alpha = torch.softmax(logits, dim=1)
        alpha = _dropout(torch.where(mask, alpha, 0.0), self.dropout, generator)
        out = einsum_f32("skh,skhc->shc", alpha.to(v.dtype), v).reshape(S, self.out_channels)
        return out + self.lin_skip(x_seed)


def rowwise_project_edge_feats(encoder: _TransformerConvWeights, edge_x_full: torch.Tensor,
                               kv_bf16: Optional[bool] = None) -> torch.Tensor:
    """``edge_x_full @ W_m^T``: the message half of ``encoder.lin_edge`` over
    a static (E, msg_dim) feature table, (E, out_channels).

    Valid while the weights are frozen (eval): computed once, its rows stand
    in for the per-batch message projection (``nbr_msg_proj``). Zero rows
    project to zero (``lin_edge`` has no bias), so padding stays zero.
    ``kv_bf16`` (default: the encoder's) gives the JAX bf16 table: the bf16
    table times the bf16 kernel half, fp32 sums, rounded to bf16.
    """
    T = encoder.lin_edge.in_features - edge_x_full.shape[1]
    w_m = encoder.lin_edge.weight[:, T:]
    if kv_bf16 is None:
        kv_bf16 = getattr(encoder, "kv_bf16", False)
    with torch.no_grad():
        if kv_bf16:
            return (edge_x_full.to(BF16).float() @ w_m.to(BF16).float().T).to(BF16)
        return edge_x_full.float() @ w_m.T


__all__ = [
    "GraphAttentionEmbedding",
    "GraphAttentionEmbeddingRowwise",
    "TGNMeanMemoryState",
    "TGNMemory",
    "TGNMemoryState",
    "TGNPackedState",
    "pending_rows",
    "rowwise_project_edge_feats",
    "tgn_commit_staged",
    "tgn_init_state",
    "tgn_mean_init_state",
    "tgn_mean_store_messages",
    "tgn_pack_state",
    "tgn_store_messages",
    "tgn_store_messages_packed",
    "tgn_unpack_state",
]
