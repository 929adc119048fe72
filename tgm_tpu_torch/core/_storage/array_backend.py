"""Array-backed storage engine (port of ``tgm_tpu/core/_storage/array_backend.py``).

Reduced to the edge accessors the serving slice reads. It shares the
``DGData`` arrays without copying and resolves a slice by binary search over
the sorted timeline. The temporal CSR and uniform neighbour sampling are
queued in ROADMAP.md.
"""

from __future__ import annotations

from typing import Optional, Set, Tuple

import numpy as np

from .base import DGSliceTracker


class DGStorageArrayBackend:
    """Sorted host arrays of one ``DGData``."""

    def __init__(self, data: "DGData") -> None:
        self._data = data

    def _edge_sel(self, sl: DGSliceTracker) -> slice:
        ts = self._data.time
        t_lo = ts[0] if sl.start_time is None else sl.start_time
        t_hi = ts[-1] if sl.end_time is None else sl.end_time
        lo = sl.start_idx or 0
        hi = len(ts) if sl.end_idx is None else sl.end_idx
        clamp = lambda x: max(lo, min(hi, x))
        lb = clamp(int(np.searchsorted(ts, t_lo, side="left")))
        ub = clamp(int(np.searchsorted(ts, t_hi, side="right")))
        # Event masks are sorted, so a [lb, ub) timeline window is a
        # contiguous run of edges.
        em = self._data.edge_mask
        return slice(int(np.searchsorted(em, lb)), int(np.searchsorted(em, ub)))

    def get_nodes(self, sl: DGSliceTracker) -> Set[int]:
        return set(np.unique(self._data.edge_index[self._edge_sel(sl)]).tolist())

    def get_edges(self, sl: DGSliceTracker) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        sel = self._edge_sel(sl)
        edges = self._data.edge_index[sel]
        time = self._data.time[self._data.edge_mask[sel]]
        return edges[:, 0], edges[:, 1], time

    def get_edge_x(self, sl: DGSliceTracker) -> Optional[np.ndarray]:
        if self._data.edge_x is None:
            return None
        return self._data.edge_x[self._edge_sel(sl)]

    def get_edge_x_dim(self) -> Optional[int]:
        return None if self._data.edge_x is None else self._data.edge_x.shape[1]
