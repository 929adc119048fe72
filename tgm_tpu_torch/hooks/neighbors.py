"""Recency neighbour hook (port of ``tgm_tpu/hooks/neighbors.py``).

Two state layouts, as in the JAX package, each with N+1 rows whose row N is
the dump row: invalid seeds read it and dropped writes aim at it, so every
gather and scatter has a static shape. ``write_pos`` grows without bound and
is reduced modulo B only where it is used.

* feature layout (the default): ``(nbr_ids, nbr_times, nbr_feats,
  write_pos)`` with (N+1, B) int32 ids and times and an (N+1, B, D) fp32
  buffer holding each event's edge features by value. A query selects each
  seed's K most recent events with their features (kernel K4 on the card).
* eid layout (``edge_x_full`` given): ``(nbr_ids, nbr_times, nbr_eids,
  write_pos)``, all int32; a query selects ids, times and edge ids and
  copies the selected edges' rows of the static feature table, in one
  launch of kernel K1 that reads the state in place (``recency_eid_select``).

A push writes a batch of events with the dense, sort-free plan of the JAX
package (bit-equal to its sorted plan), planned and written on the card by
the push kernel (``ops.recency_push``, two launches) for both layouts. The
buffers are updated in place; the dump row is never written.

A multi-hop query (TGAT) runs one select a hop: hop i+1's seeds and times
are hop i's neighbours and their times, flattened (PAD seeds read the dump
row), and the push runs once, after every hop. The packed layout and the
uniform ``NeighborSamplerHook`` are queued in ROADMAP.md.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch

from ..constants import PADDED_NODE_ID
from ..core.batch import DGBatch
from ..core.graph import DGraph
from ..device import DeviceLike, resolve_device
from ..ops.recency_select import recency_eid_select, recency_window_select, seed_rows
from ..ops.scatter_cells import recency_push
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
    nbr_ids, nbr_times, nbr_feats, write_pos = state
    rows = seed_rows(seeds, nbr_ids.shape[0] - 1)
    return recency_window_select(
        nbr_ids[rows], nbr_times[rows], nbr_feats[rows], write_pos[rows],
        seed_times.int(), k,
    )


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


@hook
class RecencyNeighborHook(SeedableHook, StatefulHook):
    """K most-recent temporal neighbours per node, maintained incrementally.

    Two state layouts (unpacked), for one hop or several (``num_nbrs``
    has one count per hop; the rings hold ``max(num_nbrs)`` slots):

    * default: the ring buffers hold each event's edge features by value in
      an (N+1, B, D) fp32 buffer (D = ``edge_dim``, else the graph's edge
      feature width, else 0); pushes take ``batch.edge_x`` (zeros if absent).
    * ``edge_x_full`` given: the ring buffers hold int32 edge ids and
      features are gathered from ``edge_x_full``, the PRE-SPLIT dataset's
      feature table, so the global ``edge_ids`` of every split's batches
      resolve.

    Every product is a list with one entry per hop: ``seed_nids[i]`` and
    ``seed_times[i]`` (S_i,) are hop i's seeds (hop 0: the batch's seeds,
    hop i + 1: hop i's neighbours flattened), ``nbr_nids[i]``,
    ``nbr_edge_time[i]`` (S_i, K_i) and ``nbr_edge_x[i]`` (S_i, K_i, D)
    their neighbours.
    """

    _cls_requires = {"edge_src", "edge_dst", "edge_time"}
    _cls_produces = {
        "seed_nids",
        "seed_times",
        "nbr_nids",
        "nbr_edge_time",
        "nbr_edge_x",
        "seed_node_nbr_mask",
    }

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
        if not len(num_nbrs):
            raise ValueError("num_nbrs must be non-empty")
        if not all(isinstance(x, int) and x > 0 for x in num_nbrs):
            raise ValueError("Each value in num_nbrs must be a positive integer")
        if len(seed_nodes_keys) != len(seed_times_keys):
            raise ValueError(
                f"len(seed_nodes_keys) ({len(seed_nodes_keys)}) != "
                f"len(seed_times_keys) ({len(seed_times_keys)})"
            )
        if packed_buffers:
            raise NotImplementedError(
                "the packed recency layout (packed_buffers=True) is queued in ROADMAP.md"
            )
        super().__init__(seed_keys=seed_nodes_keys, id=id)
        self._num_nodes = num_nodes
        self._num_nbrs = list(num_nbrs)
        self._directed = directed
        self._seed_nodes_keys = seed_nodes_keys
        self._seed_times_keys = seed_times_keys
        self.device = resolve_device(device)
        self._edge_dim = edge_dim
        self._edge_x_full = (None if edge_x_full is None else
                             torch.as_tensor(edge_x_full, dtype=torch.float32, device=self.device))

    @property
    def num_nbrs(self) -> List[int]:
        return self._num_nbrs

    def init_state(self, dg: Optional[DGraph] = None) -> Any:
        if self._edge_x_full is not None:
            return recency_eid_init(self._num_nodes, max(self._num_nbrs), self.device)
        if self._edge_dim is None:
            self._edge_dim = (dg.edge_x_dim if dg is not None else 0) or 0
        return recency_init(self._num_nodes, max(self._num_nbrs), self._edge_dim, self.device)

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

    def _query(self, state: Any, seeds: torch.Tensor, times: torch.Tensor, k: int):
        """One hop: (S, K) ids and times and (S, K, D) features; one launch of
        K1 (eid layout, features fused) or of K4 (feature layout)."""
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
        seeds, times, seed_mask = self._get_seeds(batch)
        hop_seeds, hop_times, hop_nbrs, hop_nbr_t, hop_nbr_x = [seeds], [times], [], [], []
        for hop, k in enumerate(self._num_nbrs):
            if hop > 0:
                hop_seeds.append(hop_nbrs[-1].reshape(-1))
                hop_times.append(hop_nbr_t[-1].reshape(-1))
            nbrs, nts, nxs = self._query(state, hop_seeds[-1], hop_times[-1], k)
            hop_nbrs.append(nbrs)
            hop_nbr_t.append(nts)
            hop_nbr_x.append(nxs)
        if eid_layout:
            state = recency_eid_update(
                state, batch.edge_src, batch.edge_dst, batch.edge_time, batch.edge_ids,
                batch.edge_valid, self._directed,
            )
        else:
            state = recency_update(
                state, batch.edge_src, batch.edge_dst, batch.edge_time,
                batch.edge_x if batch.has("edge_x") else None, batch.edge_valid, self._directed,
            )
        self.add_batch_attribute(batch, "seed_nids", hop_seeds)
        self.add_batch_attribute(batch, "seed_times", hop_times)
        self.add_batch_attribute(batch, "nbr_nids", hop_nbrs)
        self.add_batch_attribute(batch, "nbr_edge_time", hop_nbr_t)
        self.add_batch_attribute(batch, "nbr_edge_x", hop_nbr_x)
        self.add_batch_attribute(batch, "seed_node_nbr_mask", seed_mask)
        return state, batch
