"""Storage engine ABC and slice tracker (port of ``tgm_tpu/core/_storage/base.py``).

Storage methods return host numpy arrays; tensors are made once, at the
``DGraph`` or loader level.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Optional, Set, Tuple

import numpy as np


@dataclass(frozen=True)
class DGSliceTracker:
    """A temporal and/or event-index slice of a dynamic graph.

    Time bounds are inclusive on both ends; index bounds clamp the global
    event-timeline range ``[start_idx, end_idx)``.
    """

    start_time: Optional[int] = None
    end_time: Optional[int] = None
    start_idx: Optional[int] = None
    end_idx: Optional[int] = None


class DGStorageBase(ABC):
    """Base class for dynamic-graph storage engines."""

    @abstractmethod
    def __init__(self, data: "DGData") -> None: ...  # noqa: D107

    @abstractmethod
    def get_start_time(self, slice: DGSliceTracker) -> Optional[int]: ...

    @abstractmethod
    def get_end_time(self, slice: DGSliceTracker) -> Optional[int]: ...

    @abstractmethod
    def get_nodes(self, slice: DGSliceTracker) -> Set[int]: ...

    @abstractmethod
    def get_edges(self, slice: DGSliceTracker) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Return (src, dst, time) arrays for edge events in the slice."""

    def get_edge_rows(self, slice: DGSliceTracker) -> Optional[slice]:
        """The slice's edge rows as a contiguous ``slice`` into this storage's
        edge arrays, or None if the backend cannot express it contiguously."""
        return None

    @abstractmethod
    def get_node_events(self, slice: DGSliceTracker) -> Tuple[np.ndarray, np.ndarray]:
        """Return (node_ids, time) for dynamic node events in the slice."""

    @abstractmethod
    def get_node_labels(self, slice: DGSliceTracker) -> Tuple[np.ndarray, np.ndarray]:
        """Return (node_ids, time) for node labels in the slice."""

    @abstractmethod
    def get_num_timestamps(self, slice: DGSliceTracker) -> int: ...

    @abstractmethod
    def get_num_events(self, slice: DGSliceTracker) -> int: ...

    @abstractmethod
    def get_node_x(self, slice: DGSliceTracker
                   ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Return (time, nids, feats) of the dynamic node features in the slice."""

    @abstractmethod
    def get_node_y(self, slice: DGSliceTracker
                   ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Return (time, nids, labels) of the node labels in the slice."""

    @abstractmethod
    def get_edge_x(self, slice: DGSliceTracker) -> Optional[np.ndarray]: ...

    @abstractmethod
    def get_edge_type(self, slice: DGSliceTracker) -> Optional[np.ndarray]: ...

    @abstractmethod
    def get_static_node_x(self) -> Optional[np.ndarray]: ...

    @abstractmethod
    def get_node_type(self) -> Optional[np.ndarray]: ...

    @abstractmethod
    def get_node_x_dim(self) -> Optional[int]: ...

    @abstractmethod
    def get_node_y_dim(self) -> Optional[int]: ...

    @abstractmethod
    def get_edge_x_dim(self) -> Optional[int]: ...

    @abstractmethod
    def get_static_node_x_dim(self) -> Optional[int]: ...

    @abstractmethod
    def get_nbrs(
        self,
        seed_nodes: np.ndarray,
        num_nbrs: int,
        slice: DGSliceTracker,
        directed: bool,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Uniformly sample up to ``num_nbrs`` temporal neighbours per seed.

        Returns ``(nbr_nids, nbr_times, nbr_feats)`` of shapes
        ``(B, num_nbrs)``, ``(B, num_nbrs)``, ``(B, num_nbrs, D_edge)``,
        left-aligned and padded with ``PADDED_NODE_ID`` / zeros.
        """
