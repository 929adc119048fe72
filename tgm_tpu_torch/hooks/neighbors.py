"""Recency neighbour hook (port of ``tgm_tpu/hooks/neighbors.py``).

Two state layouts, as in the JAX package, each with N+1 rows whose row N is
the dump row: invalid seeds read it and dropped writes aim at it, so every
gather and scatter has a static shape. ``write_pos`` grows without bound and
is reduced modulo B only where it is used.

* feature layout (the default): ``(nbr_ids, nbr_times, nbr_feats,
  write_pos)`` with (N+1, B) int32 ids and times and an (N+1, B, D) fp32
  buffer holding each event's edge features by value. A query selects each
  seed's K most recent events with their features, in one launch of kernel
  K4 that reads the state in place (``recency_feats_select``).
* eid layout (``edge_x_full`` given): ``(nbr_ids, nbr_times, nbr_eids,
  write_pos)``, all int32; a query selects ids, times and edge ids and
  copies the selected edges' rows of the static feature table, in one
  launch of kernel K1 that reads the state in place (``recency_eid_select``).

A push writes a batch of events with the dense, sort-free plan of the JAX
package (bit-equal to its sorted plan), planned and written on the card by
the push kernel (``ops.recency_push``, two launches) for both layouts. The
buffers are updated in place; the dump row is never written.

* packed layout (``edge_x_full`` and ``packed_buffers=True``): one (N+1,
  B, 3) int32 buffer of [id, time, edge id] rows and the write positions.
  A query gathers each seed's (B, 3) rows at once and runs K1's
  pre-gathered entry (``recency_window_select_eid``) over their planes; a
  push writes whole rows with one ``index_put_`` of the dense plan
  (``push_plan_dense``), then resets the dump row to (PAD, 0, -1).

A multi-hop query (TGAT) runs one select a hop: hop i+1's seeds and times
are hop i's neighbours and their times, flattened (PAD seeds read the dump
row), and the push runs once, after every hop.

``NeighborSamplerHook`` samples uniformly instead, over the temporal CSR
of the storage it first sees: each seed's neighbours strictly before the
batch, all of them (oldest first) where there are at most K, else K
distinct ones drawn with Floyd's algorithm.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..constants import PADDED_NODE_ID
from ..core.batch import DGBatch
from ..core.graph import DGraph
from ..device import DeviceLike, resolve_device
from ..ops.recency_select import (
    gather_edge_feats,
    recency_eid_select,
    recency_feats_select,
    recency_window_select_eid,
    seed_rows,
)
from ..ops.scatter_cells import push_plan_dense, recency_push
from .base import SeedableHook, StatefulHook
from .registry import hook

# (nbr_ids, nbr_times, nbr_feats or nbr_eids, write_pos)
RecencyState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def recency_init(num_nodes: int, buf_size: int, edge_dim: int,
                 device: DeviceLike = None) -> RecencyState:
    """(N+1, B) id/time buffers, an (N+1, B, D) fp32 feature buffer and write
    positions; row N is the dump row."""
    dev = resolve_device(device)
    n = num_nodes + 1
    i32 = dict(dtype=torch.int32, device=dev)
    return (
        torch.full((n, buf_size), PADDED_NODE_ID, **i32),
        torch.zeros((n, buf_size), **i32),
        torch.zeros((n, buf_size, edge_dim), dtype=torch.float32, device=dev),
        torch.zeros((n,), **i32),
    )


def recency_query(
    state: RecencyState, seeds: torch.Tensor, seed_times: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K most recent (nbr_id, time, features) per seed strictly before its time."""
    return recency_feats_select(state, seeds.int(), seed_times.int(), k)


def recency_eid_init(num_nodes: int, buf_size: int, device: DeviceLike = None) -> RecencyState:
    """(N+1, B) id/time/edge-id buffers plus write positions; row N is the dump row."""
    dev = resolve_device(device)
    n = num_nodes + 1
    i32 = dict(dtype=torch.int32, device=dev)
    return (
        torch.full((n, buf_size), PADDED_NODE_ID, **i32),
        torch.zeros((n, buf_size), **i32),
        torch.full((n, buf_size), -1, **i32),
        torch.zeros((n,), **i32),
    )


def recency_eid_query(
    state: RecencyState, seeds: torch.Tensor, seed_times: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K most recent (nbr_id, time, edge_id) per seed strictly before its time."""
    return recency_eid_select(state, seeds.int(), seed_times.int(), k)[:3]


def _recency_push(state: RecencyState, src: torch.Tensor, dst: torch.Tensor, time: torch.Tensor,
                  payload: torch.Tensor, valid: Optional[torch.Tensor],
                  directed: bool) -> RecencyState:
    """Ring-buffer push over id/time/payload buffers, in place."""
    nbr_ids, nbr_times, payload_buf, write_pos = state
    return recency_push(nbr_ids, nbr_times, payload_buf, write_pos, src.int(), dst.int(),
                        time.int(), payload.to(payload_buf.dtype), valid, directed)


def recency_update(
    state: RecencyState,
    src: torch.Tensor,
    dst: torch.Tensor,
    time: torch.Tensor,
    feats: Optional[torch.Tensor],
    valid: Optional[torch.Tensor],
    directed: bool,
) -> RecencyState:
    """Push a batch of edge events with their feature rows into the buffers, in place."""
    if feats is None:
        feats = torch.zeros((src.shape[0], state[2].shape[-1]), dtype=torch.float32,
                            device=src.device)
    return _recency_push(state, src, dst, time, feats, valid, directed)


def recency_eid_update(
    state: RecencyState,
    src: torch.Tensor,
    dst: torch.Tensor,
    time: torch.Tensor,
    eids: torch.Tensor,
    valid: Optional[torch.Tensor],
    directed: bool,
) -> RecencyState:
    """Push a batch of edge events (by edge id) into the ring buffers, in place."""
    return _recency_push(state, src, dst, time, eids, valid, directed)


# (buf (N+1, B, 3) int32 [id, time, edge id], write_pos (N+1,) int32)
PackedRecencyState = Tuple[torch.Tensor, torch.Tensor]
_PK_DUMP_FILL = (PADDED_NODE_ID, 0, -1)


def recency_pk_init(num_nodes: int, buf_size: int,
                    device: DeviceLike = None) -> PackedRecencyState:
    """The packed layout: an (N+1, B, 3) buffer of (PAD, 0, -1) rows and
    write positions; row N is the dump row."""
    dev = resolve_device(device)
    n = num_nodes + 1
    buf = torch.tensor(_PK_DUMP_FILL, dtype=torch.int32, device=dev).repeat(n, buf_size, 1)
    return buf, torch.zeros((n,), dtype=torch.int32, device=dev)


def recency_pk_query(
    state: PackedRecencyState, seeds: torch.Tensor, seed_times: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K most recent (nbr_id, time, edge_id) per seed strictly before its time:
    one (S, B, 3) gather, then K1's pre-gathered entry over its planes."""
    buf, write_pos = state
    rows = seed_rows(seeds, buf.shape[0] - 1)
    g = buf[rows]
    return recency_window_select_eid(g[:, :, 0], g[:, :, 1], g[:, :, 2], write_pos[rows],
                                     seed_times.int(), k)


def recency_pk_update(
    state: PackedRecencyState,
    src: torch.Tensor,
    dst: torch.Tensor,
    time: torch.Tensor,
    eids: torch.Tensor,
    valid: Optional[torch.Tensor],
    directed: bool,
) -> PackedRecencyState:
    """Push a batch of edge events into the packed buffer, in place: the
    dense plan, one row write, then the dump row reset to (PAD, 0, -1)."""
    buf, write_pos = state
    num_nodes = buf.shape[0] - 1
    rows, cols, s_nbrs, s_t, rows_last, wp_last = push_plan_dense(
        buf.shape[1], write_pos, src.int(), dst.int(), time.int(), valid, directed, num_nodes)
    e = eids if directed else torch.cat([eids, eids])
    write_pos[rows_last.long()] = wp_last
    buf[rows.long(), cols.long()] = torch.stack([s_nbrs, s_t, e.int()], dim=1)
    for c, fill in enumerate(_PK_DUMP_FILL):
        buf[num_nodes, :, c] = fill
    write_pos[num_nodes] = 0
    return buf, write_pos


class _NeighborHookBase(SeedableHook, StatefulHook):
    """Shared multi-hop plumbing: argument checks, seed collection and the
    per-hop products."""

    _cls_requires = {"edge_src", "edge_dst", "edge_time"}
    _cls_produces = {
        "seed_nids",
        "seed_times",
        "nbr_nids",
        "nbr_edge_time",
        "nbr_edge_x",
        "seed_node_nbr_mask",
    }

    def __init__(self, num_nbrs: Sequence[int], seed_nodes_keys: List[str],
                 seed_times_keys: List[str], directed: bool, device: DeviceLike,
                 id: Optional[str]) -> None:
        if not len(num_nbrs):
            raise ValueError("num_nbrs must be non-empty")
        if not all(isinstance(x, int) and x > 0 for x in num_nbrs):
            raise ValueError("Each value in num_nbrs must be a positive integer")
        if len(seed_nodes_keys) != len(seed_times_keys):
            raise ValueError(
                f"len(seed_nodes_keys) ({len(seed_nodes_keys)}) != "
                f"len(seed_times_keys) ({len(seed_times_keys)})"
            )
        super().__init__(seed_keys=seed_nodes_keys, id=id)
        self._num_nbrs = list(num_nbrs)
        self._directed = directed
        self._seed_nodes_keys = seed_nodes_keys
        self._seed_times_keys = seed_times_keys
        self.device = resolve_device(device)

    @property
    def num_nbrs(self) -> List[int]:
        return self._num_nbrs

    def _get_seeds(self, batch: DGBatch):
        seeds, times, mask = [], [], {}
        offset = 0
        for nk, tk in zip(self._seed_nodes_keys, self._seed_times_keys):
            if not batch.has(nk) or not batch.has(tk):
                raise ValueError(f"Missing seed attributes {[nk, tk]} on batch")
            s, t = getattr(batch, nk), getattr(batch, tk)
            seeds.append(s.int())
            times.append(t.int())
            mask[nk] = torch.arange(offset, offset + s.shape[0], device=s.device)
            offset += s.shape[0]
        return torch.cat(seeds), torch.cat(times), mask

    def _hops(self, state: Any, batch: DGBatch, query) -> DGBatch:
        """Run ``query(state, seeds, times, k) -> (ids, times, feats)`` hop by
        hop and attach the products."""
        seeds, times, seed_mask = self._get_seeds(batch)
        hop_seeds, hop_times, hop_nbrs, hop_nbr_t, hop_nbr_x = [seeds], [times], [], [], []
        for hop, k in enumerate(self._num_nbrs):
            if hop > 0:
                hop_seeds.append(hop_nbrs[-1].reshape(-1))
                hop_times.append(hop_nbr_t[-1].reshape(-1))
            nbrs, nts, nxs = query(state, hop_seeds[-1], hop_times[-1], k)
            hop_nbrs.append(nbrs)
            hop_nbr_t.append(nts)
            hop_nbr_x.append(nxs)
        self.add_batch_attribute(batch, "seed_nids", hop_seeds)
        self.add_batch_attribute(batch, "seed_times", hop_times)
        self.add_batch_attribute(batch, "nbr_nids", hop_nbrs)
        self.add_batch_attribute(batch, "nbr_edge_time", hop_nbr_t)
        self.add_batch_attribute(batch, "nbr_edge_x", hop_nbr_x)
        self.add_batch_attribute(batch, "seed_node_nbr_mask", seed_mask)
        return batch


@hook
class RecencyNeighborHook(_NeighborHookBase):
    """K most-recent temporal neighbours per node, maintained incrementally.

    Three state layouts, for one hop or several (``num_nbrs`` has one count
    per hop; the rings hold ``max(num_nbrs)`` slots):

    * default: the ring buffers hold each event's edge features by value in
      an (N+1, B, D) fp32 buffer (D = ``edge_dim``, else the graph's edge
      feature width, else 0); pushes take ``batch.edge_x`` (zeros if absent).
    * ``edge_x_full`` given: the ring buffers hold int32 edge ids and
      features are gathered from ``edge_x_full``, the PRE-SPLIT dataset's
      feature table, so the global ``edge_ids`` of every split's batches
      resolve.
    * ``edge_x_full`` and ``packed_buffers=True``: the edge-id layout packed
      into one (N+1, B, 3) buffer of [id, time, edge id] rows.

    Every product is a list with one entry per hop: ``seed_nids[i]`` and
    ``seed_times[i]`` (S_i,) are hop i's seeds (hop 0: the batch's seeds,
    hop i + 1: hop i's neighbours flattened), ``nbr_nids[i]``,
    ``nbr_edge_time[i]`` (S_i, K_i) and ``nbr_edge_x[i]`` (S_i, K_i, D)
    their neighbours.
    """

    def __init__(
        self,
        num_nodes: int,
        num_nbrs: Sequence[int],
        seed_nodes_keys: List[str],
        seed_times_keys: List[str],
        directed: bool = False,
        edge_dim: Optional[int] = None,
        edge_x_full: Optional[Any] = None,
        packed_buffers: bool = False,
        device: DeviceLike = None,
        id: Optional[str] = None,
    ) -> None:
        super().__init__(num_nbrs, seed_nodes_keys, seed_times_keys, directed, device, id)
        self._num_nodes = num_nodes
        self._edge_dim = edge_dim
        self._edge_x_full = (None if edge_x_full is None else
                             torch.as_tensor(edge_x_full, dtype=torch.float32, device=self.device))
        self._packed = bool(packed_buffers)
        if self._packed and self._edge_x_full is None:
            raise ValueError("packed_buffers requires edge_x_full (eid mode)")

    def init_state(self, dg: Optional[DGraph] = None) -> Any:
        B = max(self._num_nbrs)
        if self._packed:
            return recency_pk_init(self._num_nodes, B, self.device)
        if self._edge_x_full is not None:
            return recency_eid_init(self._num_nodes, B, self.device)
        if self._edge_dim is None:
            self._edge_dim = (dg.edge_x_dim if dg is not None else 0) or 0
        return recency_init(self._num_nodes, B, self._edge_dim, self.device)

    def _query(self, state: Any, seeds: torch.Tensor, times: torch.Tensor, k: int):
        """One hop: (S, K) ids and times and (S, K, D) features; one launch of
        K1 (eid layout, features fused; packed layout, pre-gathered rows) or
        of K4 (feature layout, the state read in place)."""
        if self._packed:
            nbrs, nts, nes = recency_pk_query(state, seeds, times, k)
            return nbrs, nts, gather_edge_feats(self._edge_x_full, nes)
        if self._edge_x_full is not None:
            nbrs, nts, _, nxs = recency_eid_select(state, seeds, times, k, self._edge_x_full)
            return nbrs, nts, nxs
        return recency_query(state, seeds, times, k)

    def apply(self, state: Any, batch: DGBatch) -> Tuple[Any, DGBatch]:
        eid_layout = self._edge_x_full is not None
        if eid_layout and not batch.has("edge_ids"):
            raise ValueError(
                "RecencyNeighborHook(edge_x_full=...) needs batches with edge_ids "
                "(served by train.stream.DeviceEdgeStream)"
            )
        batch = self._hops(state, batch, self._query)
        if self._packed:
            state = recency_pk_update(
                state, batch.edge_src, batch.edge_dst, batch.edge_time, batch.edge_ids,
                batch.edge_valid, self._directed,
            )
        elif eid_layout:
            state = recency_eid_update(
                state, batch.edge_src, batch.edge_dst, batch.edge_time, batch.edge_ids,
                batch.edge_valid, self._directed,
            )
        else:
            state = recency_update(
                state, batch.edge_src, batch.edge_dst, batch.edge_time,
                batch.edge_x if batch.has("edge_x") else None, batch.edge_valid, self._directed,
            )
        return state, batch


_INT32_MAX = int(np.iinfo(np.int32).max)


def floyd_offsets(rand: torch.Tensor, cnt: torch.Tensor, k: int) -> torch.Tensor:
    """(S, k) distinct offsets in [0, cnt) per row with ``cnt > k``, by
    Floyd's algorithm over the draws ``rand`` (S, k), in draw order.

    Step i considers the prefix [0, t_i], t_i = cnt - k + i, draws r_i =
    rand_i mod (t_i + 1) and takes t_i instead where r_i was taken before.
    The steps run at once: the set taken before step i is {r_l : l < i}
    together with {t_l : l < i, step l took t_l}, and r_i equals t_l only for
    l = r_i - (cnt - k), so "step i took t_i" is "r_i repeats an earlier
    draw" or'ed along the chain i -> l -> ..., found by pointer jumping.
    Rows with ``cnt <= k`` give values that the caller ignores.
    """
    S = rand.shape[0]
    dev = rand.device
    i = torch.arange(k, device=dev)
    t = (cnt.long() - k)[:, None] + i[None, :]
    r = torch.remainder(rand.long(), torch.clamp_min(t + 1, 1))
    earlier = i[None, :] < i[:, None]  # [i, l]: l < i
    dup = ((r[:, :, None] == r[:, None, :]) & earlier).any(dim=2)
    link = r - (cnt.long() - k)[:, None]
    ptr = torch.where((link >= 0) & (link < i[None, :]), link, i[None, :].expand(S, k))
    for _ in range(max(1, (k - 1).bit_length())):
        dup = dup | torch.gather(dup, 1, ptr)
        ptr = torch.gather(ptr, 1, ptr)
    return torch.where(dup, t, r)


@hook
class NeighborSamplerHook(_NeighborHookBase):
    """Uniform temporal neighbour sampling over the history before the batch.

    The temporal CSR of the first graph the hook initialises on is uploaded
    once and kept across ``reset_state``, as in JAX: a hook shared by the
    splits and first initialised on train keeps querying train's edges (and
    train's node range and edge features) in val and test. Per hop, each
    seed's candidates are its CSR entries with time <= ``end_time``, the
    batch's least valid edge time minus 1 (the same for every hop). A row
    with at most K candidates takes them all, oldest first, left-aligned and
    PAD-filled; a larger row takes K distinct ones drawn by Floyd's
    algorithm (``floyd_offsets``), in draw order. The window's end is found
    with one ``searchsorted`` over the CSR's composite key, equal to the JAX
    package's 32-step bisection, including its step past a row whose
    candidates all lie before ``end_time`` onto the next entry when that
    entry is no later (ROADMAP.md fault 16). Edge features are gathered by
    the storage's edge ids, zero where nothing was taken.

    The state is the ``torch.Generator`` on the hook's device the draws
    come from (seeded with ``seed``; ``reset_state`` re-seeds it);
    :meth:`draw_offsets` draws them and tests replace it.
    """

    def __init__(
        self,
        num_nbrs: Sequence[int],
        seed_nodes_keys: List[str],
        seed_times_keys: List[str],
        directed: bool = False,
        device: DeviceLike = None,
        seed: int = 0,
        id: Optional[str] = None,
    ) -> None:
        super().__init__(num_nbrs, seed_nodes_keys, seed_times_keys, directed, device, id)
        self._seed = seed
        self._csr: Optional[Tuple[torch.Tensor, ...]] = None
        self._edge_x: Optional[torch.Tensor] = None

    def init_state(self, dg: Optional[DGraph] = None) -> Any:
        if self._csr is None:
            if dg is None:
                raise ValueError("NeighborSamplerHook needs a graph for its first init_state")
            row_ptr, nbrs, times, eids, key, key_base = dg._storage.temporal_csr(self._directed)
            up = lambda a: torch.as_tensor(a, device=self.device)
            self._csr = (up(row_ptr), up(nbrs), up(times.astype(np.int32)),
                         up(eids), up(key), int(key_base))
            edge_x = dg._storage._data.edge_x
            self._edge_x = None if edge_x is None else up(edge_x)
        return torch.Generator(device=self.device).manual_seed(self._seed)

    def draw_offsets(self, generator: torch.Generator, S: int, k: int) -> torch.Tensor:
        """(S, k) int32 draws uniform in [0, 2^31 - 1) on the hook's device."""
        return torch.randint(0, _INT32_MAX, (S, k), generator=generator, device=self.device,
                             dtype=torch.int32)

    def sample(self, seeds: torch.Tensor, end_time: torch.Tensor, k: int,
               rand: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(S, K) ids and times and (S, K, D) features of each seed's sample
        among its neighbours at or before ``end_time``, given the draws."""
        row_ptr, nbrs, times, eids, key, key_base = self._csr
        num_nodes = row_ptr.shape[0] - 1
        E = times.shape[0]
        seed_ok = (seeds >= 0) & (seeds < num_nodes)
        rows = torch.where(seed_ok, seeds, 0).long()
        lo, hi0 = row_ptr[rows], row_ptr[rows + 1]
        # First entry of the row later than end_time, else the row's end...
        q = rows * key_base + end_time.long()
        end = torch.searchsorted(key, q, right=True).clamp(lo, hi0)
        # ...and the bisection's step past a row that holds none such.
        nxt = times[hi0.clamp(max=E - 1)]
        end = end + ((end == hi0) & (nxt <= end_time)).long()
        cnt = torch.where(seed_ok, (end - lo).clamp_min(0), 0)
        cols = torch.arange(k, device=seeds.device)[None, :]
        take = cols < cnt.clamp(max=k)[:, None]
        offs = torch.where((cnt > k)[:, None], floyd_offsets(rand, cnt, k), cols)
        idx = (lo[:, None] + offs).clamp(0, E - 1)
        out_ids = torch.where(take, nbrs[idx], PADDED_NODE_ID)
        out_t = torch.where(take, times[idx], 0)
        if self._edge_x is None:
            out_x = torch.zeros((seeds.shape[0], k, 0), dtype=torch.float32, device=seeds.device)
        else:
            out_x = torch.where(take[:, :, None], self._edge_x[eids[idx]], 0.0)
        return out_ids, out_t, out_x

    def apply(self, state: Any, batch: DGBatch) -> Tuple[Any, DGBatch]:
        if batch.edge_valid is not None:
            t_min = torch.where(batch.edge_valid, batch.edge_time, _INT32_MAX).min()
        else:
            t_min = batch.edge_time.min()
        end_time = t_min.long() - 1  # strictly before this batch

        def query(generator, seeds, times, k):
            return self.sample(seeds, end_time, k, self.draw_offsets(generator, seeds.shape[0], k))

        return state, self._hops(state, batch, query)
