"""Validated host-side container for temporal graph edge events.

Port of ``tgm_tpu/data/dg_data.py`` reduced to what the serving slice reads:
``DGData.from_raw`` over edge events with its validation, ``split()``,
``num_nodes``, ``edge_x`` and ``edge_global_offset``. Node features, node
labels, discretization and the CSV/pandas/TGB constructors are queued in
ROADMAP.md. Everything here is numpy on the host; device upload happens once,
in ``train.stream.DeviceEdgeStream``.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np

from ..constants import PADDED_NODE_ID
from ..exceptions import EmptyGraphError, InvalidNodeIDError

_INT32_MAX = np.iinfo(np.int32).max


def _as_array(x: Any, name: str) -> np.ndarray:
    arr = np.asarray(x)
    if arr.dtype.kind == "f" and np.isnan(arr).any():
        raise ValueError(f"{name} contains NaN values")
    return arr


def _require_integral(x: np.ndarray, name: str) -> None:
    if x.dtype.kind not in ("i", "u"):
        raise TypeError(f"{name} must have integer dtype, got {x.dtype}")


def _to_float32(x: np.ndarray, name: str) -> np.ndarray:
    if x.dtype == np.float64:
        warnings.warn(f"Downcasting {name} from float64 to float32", UserWarning)
    return x.astype(np.float32) if x.dtype != np.float32 else x


def _to_int32(x: np.ndarray, name: str) -> np.ndarray:
    if x.dtype == np.int64:
        warnings.warn(f"Downcasting {name} from int64 to int32", UserWarning)
    return x.astype(np.int32) if x.dtype != np.int32 else x


@dataclass
class DGData:
    """Edge events of a dynamic graph, sorted by time.

    ``time`` is the sorted int64 event timeline and ``edge_mask`` indexes the
    edge events in it (every event is an edge event in this port).
    """

    time_delta: str
    time: np.ndarray  # [num_events] int64, sorted
    edge_mask: np.ndarray  # [num_edge_events] int32 indices into `time`
    edge_index: np.ndarray  # [num_edge_events, 2] int32
    edge_x: Optional[np.ndarray] = None  # [num_edge_events, D_edge] float32

    _split_strategy: Any = None

    # Row of this data's first edge inside the pre-split parent dataset (set
    # by split strategies, whose selections are contiguous). Per-split streams
    # emit GLOBAL edge ids so one full-dataset feature table serves every split.
    edge_global_offset: int = 0

    def __post_init__(self) -> None:
        self.time = _as_array(self.time, "timestamps")
        _require_integral(self.time, "timestamps")
        if self.time.size and self.time.min() < 0:
            raise ValueError("timestamps must all be non-negative")
        if self.time.size and int(self.time.max()) >= _INT32_MAX:
            raise ValueError(f"timestamps exceed the int32 limit ({_INT32_MAX})")
        self.time = self.time.astype(np.int64)

        self.edge_index = _as_array(self.edge_index, "edge_index")
        _require_integral(self.edge_index, "edge_index")
        if self.edge_index.ndim != 2 or self.edge_index.shape[1] != 2:
            raise ValueError(
                f"edge_index must have shape [num_edges, 2], got {self.edge_index.shape}"
            )
        if np.any(self.edge_index == PADDED_NODE_ID):
            raise InvalidNodeIDError(
                f"Edge events contain node ids matching PADDED_NODE_ID ({PADDED_NODE_ID}); "
                "remap node ids to non-negative integers."
            )
        if self.edge_index.size and int(self.edge_index.max()) >= _INT32_MAX:
            raise InvalidNodeIDError(f"Edge node ids exceed the int32 limit ({_INT32_MAX})")
        self.edge_index = _to_int32(self.edge_index, "edge_index")

        num_edges = self.edge_index.shape[0]
        if num_edges == 0:
            raise EmptyGraphError("Graphs without edge events are not supported")

        self.edge_mask = _as_array(self.edge_mask, "edge_mask")
        _require_integral(self.edge_mask, "edge_mask")
        self.edge_mask = self.edge_mask.astype(np.int32)
        if self.edge_mask.shape[0] != num_edges:
            raise ValueError("edge_mask must have shape [num_edges]")

        if self.edge_x is not None:
            self.edge_x = _as_array(self.edge_x, "edge_x")
            if self.edge_x.ndim != 2 or self.edge_x.shape[0] != num_edges:
                raise ValueError(
                    f"edge features must have shape [num_edges, D_edge], got {self.edge_x.shape}"
                )
            self.edge_x = _to_float32(self.edge_x, "edge_x")

        if self.time.ndim != 1 or self.time.shape[0] != num_edges:
            raise ValueError(f"time must have shape [{num_edges}], got {self.time.shape}")
        self._sort_if_needed()

    def _sort_if_needed(self) -> None:
        if np.all(np.diff(self.time) >= 0):
            return
        order = np.argsort(self.time, kind="stable")
        self.time = self.time[order]
        self.edge_index = self.edge_index[order]
        if self.edge_x is not None:
            self.edge_x = self.edge_x[order]

    @property
    def edge_time(self) -> np.ndarray:
        return self.time[self.edge_mask]

    @property
    def num_nodes(self) -> int:
        return int(self.edge_index.max()) + 1

    @property
    def num_edge_events(self) -> int:
        return self.edge_index.shape[0]

    def split(self, strategy: Any = None) -> Tuple["DGData", ...]:
        """Split into train/val/test (default: 70/15/15 ``TemporalRatioSplit``).

        A TGB strategy attached to the data cannot be overridden.
        """
        from .split import TemporalRatioSplit, TGBSplit

        strategy = strategy or self._split_strategy or TemporalRatioSplit()
        if isinstance(self._split_strategy, TGBSplit) and strategy is not self._split_strategy:
            raise ValueError("Cannot override split strategy for TGB datasets")
        return strategy.apply(self)

    @classmethod
    def from_raw(
        cls,
        edge_time: np.ndarray,
        edge_index: np.ndarray,
        edge_x: Optional[np.ndarray] = None,
        time_delta: str = "r",
    ) -> "DGData":
        """Build the sorted timeline from per-edge times."""
        edge_time = _as_array(edge_time, "edge_time")
        return cls(
            time_delta=time_delta,
            time=edge_time,
            edge_mask=np.arange(len(edge_time)),
            edge_index=edge_index,
            edge_x=edge_x,
        )
