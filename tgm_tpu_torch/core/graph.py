"""Immutable dynamic-graph view (port of ``tgm_tpu/core/graph.py``).

Reduced to the accessors that the device stream and the hooks read:
``_storage.get_edges(slice)``, ``_storage.get_edge_x(slice)``, ``edge_dst``,
``num_nodes``, ``num_edge_events`` and ``edge_x_dim``. Slicing and
``materialize`` are queued in ROADMAP.md; batches come from
``train.stream.DeviceEdgeStream``.
"""

from __future__ import annotations

from functools import cached_property
from typing import Optional

import numpy as np

from ._storage import DGSliceTracker, DGStorage


class DGraph:
    """A view of the whole of one ``DGData``."""

    def __init__(self, data: "DGData") -> None:
        from ..data.dg_data import DGData

        if not isinstance(data, DGData):
            raise TypeError(f"DGraph must be initialized with DGData, got {type(data)}")
        self._storage = DGStorage(data)
        self._slice = DGSliceTracker()

    @cached_property
    def num_nodes(self) -> int:
        nodes = self._storage.get_nodes(self._slice)
        return max(nodes) + 1 if nodes else 0

    @cached_property
    def num_edge_events(self) -> int:
        return len(self.edge_dst)

    @cached_property
    def edge_dst(self) -> np.ndarray:
        return self._storage.get_edges(self._slice)[1]

    @cached_property
    def edge_x_dim(self) -> Optional[int]:
        return self._storage.get_edge_x_dim()
