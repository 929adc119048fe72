"""Array-backed storage engine (port of ``tgm_tpu/core/_storage/array_backend.py``).

The edge, node-feature, node-label and type accessors, the temporal CSR
the uniform neighbour sampler queries (sorted by the C++ ``lexsort2_perm``)
and ``get_nbrs``, its host sampler. It shares the ``DGData`` arrays without
copying and resolves a slice by binary search over the sorted timeline.
"""

from __future__ import annotations

from typing import Dict, Optional, Set, Tuple

import numpy as np

from ...constants import PADDED_NODE_ID
from ...native import lexsort2_perm
from .base import DGSliceTracker, DGStorageBase


def slice_range(sorted_idx: np.ndarray, lb: int, ub: int) -> slice:
    """Event masks are sorted, so a [lb, ub) timeline window maps to a
    contiguous range of one kind's rows."""
    a = int(np.searchsorted(sorted_idx, lb, side="left"))
    b = int(np.searchsorted(sorted_idx, ub, side="left"))
    return slice(a, b)


class DGStorageArrayBackend(DGStorageBase):
    """Sorted host arrays of one ``DGData``."""

    def __init__(self, data: "DGData") -> None:
        self._data = data
        self._csr: Dict[bool, Tuple[np.ndarray, ...]] = {}

    def _bounds(self, sl: DGSliceTracker) -> Tuple[int, int]:
        """The slice's [lb, ub) window of the global timeline."""
        ts = self._data.time
        t_lo = ts[0] if sl.start_time is None else sl.start_time
        t_hi = ts[-1] if sl.end_time is None else sl.end_time
        lo = sl.start_idx or 0
        hi = len(ts) if sl.end_idx is None else sl.end_idx
        clamp = lambda x: max(lo, min(hi, x))
        return (clamp(int(np.searchsorted(ts, t_lo, side="left"))),
                clamp(int(np.searchsorted(ts, t_hi, side="right"))))

    def _edge_sel(self, sl: DGSliceTracker) -> slice:
        return slice_range(self._data.edge_mask, *self._bounds(sl))

    def _label_sel(self, sl: DGSliceTracker) -> slice:
        return slice_range(self._data.node_y_mask, *self._bounds(sl))

    def _node_x_sel(self, sl: DGSliceTracker) -> slice:
        return slice_range(self._data.node_x_mask, *self._bounds(sl))

    def get_start_time(self, sl: DGSliceTracker) -> Optional[int]:
        lb, ub = self._bounds(sl)
        return None if lb >= ub else int(self._data.time[lb])

    def get_end_time(self, sl: DGSliceTracker) -> Optional[int]:
        lb, ub = self._bounds(sl)
        return None if lb >= ub else int(self._data.time[ub - 1])

    def get_num_events(self, sl: DGSliceTracker) -> int:
        lb, ub = self._bounds(sl)
        return ub - lb

    def get_nodes(self, sl: DGSliceTracker) -> Set[int]:
        """Ids of the slice's edges and node-feature events (not its labels)."""
        nodes = set(np.unique(self._data.edge_index[self._edge_sel(sl)]).tolist())
        if self._data.node_x_mask is not None:
            nodes.update(np.unique(self._data.node_x_nids[self._node_x_sel(sl)]).tolist())
        return nodes

    def get_edges(self, sl: DGSliceTracker) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        sel = self._edge_sel(sl)
        edges = self._data.edge_index[sel]
        time = self._data.time[self._data.edge_mask[sel]]
        return edges[:, 0], edges[:, 1], time

    def get_edge_rows(self, sl: DGSliceTracker) -> slice:
        """The slice's edges as a contiguous range of this storage's edge rows."""
        return self._edge_sel(sl)

    def get_node_events(self, sl: DGSliceTracker) -> Tuple[np.ndarray, np.ndarray]:
        """(node ids, times) of the slice's node-feature events (empty without them)."""
        if self._data.node_x_mask is None:
            return np.empty(0, np.int32), np.empty(0, np.int64)
        sel = self._node_x_sel(sl)
        return self._data.node_x_nids[sel], self._data.time[self._data.node_x_mask[sel]]

    def get_node_x(self, sl: DGSliceTracker):
        """(times, node ids, features) of the slice's node-feature events, or None."""
        if self._data.node_x_mask is None or self._data.node_x is None:
            return None
        sel = self._node_x_sel(sl)
        return (self._data.time[self._data.node_x_mask[sel]], self._data.node_x_nids[sel],
                self._data.node_x[sel])

    def get_node_labels(self, sl: DGSliceTracker) -> Tuple[np.ndarray, np.ndarray]:
        """(node ids, times) of the slice's label events (empty without labels)."""
        if self._data.node_y_mask is None:
            return np.empty(0, np.int32), np.empty(0, np.int64)
        sel = self._label_sel(sl)
        return self._data.node_y_nids[sel], self._data.time[self._data.node_y_mask[sel]]

    def get_node_y(self, sl: DGSliceTracker):
        """(times, node ids, labels) of the slice's label events, or None."""
        if self._data.node_y_mask is None or self._data.node_y is None:
            return None
        sel = self._label_sel(sl)
        return (self._data.time[self._data.node_y_mask[sel]], self._data.node_y_nids[sel],
                self._data.node_y[sel])

    def get_edge_x(self, sl: DGSliceTracker) -> Optional[np.ndarray]:
        if self._data.edge_x is None:
            return None
        return self._data.edge_x[self._edge_sel(sl)]

    def get_edge_type(self, sl: DGSliceTracker) -> Optional[np.ndarray]:
        if self._data.edge_type is None:
            return None
        return self._data.edge_type[self._edge_sel(sl)]

    def get_static_node_x(self) -> Optional[np.ndarray]:
        return self._data.static_node_x

    def get_node_type(self) -> Optional[np.ndarray]:
        return self._data.node_type

    def get_num_timestamps(self, sl: DGSliceTracker) -> int:
        lb, ub = self._bounds(sl)
        return len(np.unique(self._data.time[lb:ub]))

    def get_node_x_dim(self) -> Optional[int]:
        return None if self._data.node_x is None else self._data.node_x.shape[1]

    def get_static_node_x_dim(self) -> Optional[int]:
        sx = self._data.static_node_x
        return None if sx is None else sx.shape[1]

    def get_node_y_dim(self) -> Optional[int]:
        return None if self._data.node_y is None else self._data.node_y.shape[1]

    def get_edge_x_dim(self) -> Optional[int]:
        return None if self._data.edge_x is None else self._data.edge_x.shape[1]

    def temporal_csr(self, directed: bool) -> Tuple[np.ndarray, ...]:
        """``(row_ptr, nbr_nids, nbr_times, nbr_eids, composite_key, key_base)``
        over every edge of this storage, sorted by (node, time), cached.

        Undirected, each edge appears under both ends, interleaved eid-major,
        so the stable sort leaves equal (node, time) entries in edge-id
        order. ``composite_key = node * key_base + time`` with ``key_base =
        max time + 2`` is sorted too, so one ``searchsorted`` finds a row's
        time window. Edge ids index this storage's own edge rows.
        """
        if directed not in self._csr:
            d = self._data
            src = d.edge_index[:, 0].astype(np.int64)
            dst = d.edge_index[:, 1].astype(np.int64)
            eid = np.arange(len(src), dtype=np.int64)
            t = d.time[d.edge_mask]
            if directed:
                nodes, nbrs, eids, times = src, dst, eid, t
            else:
                nodes = np.stack([src, dst], axis=1).ravel()
                nbrs = np.stack([dst, src], axis=1).ravel()
                eids = np.repeat(eid, 2)
                times = np.repeat(t, 2)
            order = lexsort2_perm(nodes, times)  # stable: the input order breaks ties
            nodes, nbrs, eids, times = nodes[order], nbrs[order], eids[order], times[order]
            row_ptr = np.searchsorted(nodes, np.arange(d.num_nodes + 1, dtype=np.int64))
            key_base = int(d.time.max()) + 2
            self._csr[directed] = (
                row_ptr.astype(np.int64),
                nbrs.astype(np.int32),
                times.astype(np.int64),
                eids.astype(np.int64),
                nodes * key_base + times,
                np.int64(key_base),
            )
        return self._csr[directed]

    def get_nbrs(
        self,
        seed_nodes: np.ndarray,
        num_nbrs: int,
        slice: DGSliceTracker,
        directed: bool,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Up to ``num_nbrs`` neighbours of each seed at or before the slice's
        end time, left-aligned and padded with ``PADDED_NODE_ID`` / zeros:
        ``(nbr_nids (B, K) int32, nbr_times (B, K) int64, nbr_feats (B, K, D)
        float32)``. A seed with at most ``num_nbrs`` candidates takes them in
        (time, edge) order; a larger row takes a uniform draw without
        replacement from an unseeded generator, kept in that order."""
        seed_nodes = np.asarray(seed_nodes)
        row_ptr, nbrs, times, eids, composite, key_base = self.temporal_csr(directed)
        B = len(seed_nodes)
        D = self.get_edge_x_dim() or 0

        out_nids = np.full((B, num_nbrs), PADDED_NODE_ID, dtype=np.int32)
        out_times = np.zeros((B, num_nbrs), dtype=np.int64)
        out_feats = np.zeros((B, num_nbrs, D), dtype=np.float32)
        if B == 0:
            return out_nids, out_times, out_feats

        end_time = slice.end_time if slice.end_time is not None else int(self._data.time[-1])
        # The composite key's base is max time + 2: a later end time would
        # reach into the next node's keys, and means "no bound" anyway.
        end_time = min(end_time, int(key_base) - 1)
        valid_seed = seed_nodes != PADDED_NODE_ID
        safe_seed = np.where(valid_seed, seed_nodes, 0).astype(np.int64)
        lo = row_ptr[safe_seed]
        hi = np.searchsorted(composite, safe_seed * key_base + end_time, side="right")
        cnt = np.where(valid_seed, np.maximum(hi - lo, 0), 0)

        cols = np.arange(num_nbrs)[None, :]
        take = cols < np.minimum(cnt, num_nbrs)[:, None]
        idx = lo[:, None] + cols
        over = cnt > num_nbrs
        if over.any():
            rng = np.random.default_rng()
            for i in np.nonzero(over)[0]:
                choice = rng.choice(cnt[i], size=num_nbrs, replace=False)
                choice.sort()
                idx[i] = lo[i] + choice
        idx = np.where(take, np.minimum(idx, len(nbrs) - 1 if len(nbrs) else 0), 0)

        out_nids = np.where(take, nbrs[idx], PADDED_NODE_ID).astype(np.int32)
        out_times = np.where(take, times[idx], 0)
        if D:
            feats = self._data.edge_x[eids[idx]]
            out_feats = np.where(take[:, :, None], feats, 0.0).astype(np.float32)
        return out_nids, out_times, out_feats
