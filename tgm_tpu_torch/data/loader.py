"""Temporal batch iteration (port of ``tgm_tpu/data/loader.py``).

Event-ordered (``batch_unit='r'``) batches over global event indices, or
time-ordered batches over timestamp windows (the batch unit converted to
graph ticks); a batch with no event of any kind (edge, node feature or
label) skipped or raised; hooks run per batch.

The loader computes the **batch plan** once, on the host: per-batch window
bounds, each event kind's offsets and counts, and the epoch's widest window
per kind rounded up to ``pad_multiple``. Every batch it yields is
materialized on ``device`` at those widths (padded and masked;
``materialize_features=False`` leaves out ``edge_x`` and the node-feature
and label events), and ``DeviceEventStream`` serves the same plan from
arrays uploaded once.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Iterator, Literal, Optional

import numpy as np

from ..core.batch import DGBatch
from ..core.graph import DGraph
from ..device import DeviceLike, resolve_device
from ..exceptions import (
    EmptyBatchError,
    EventOrderedConversionError,
    InvalidDiscretizationError,
)
from ..timedelta import TimeDeltaDG


@dataclass(frozen=True)
class BatchPlan:
    """Per-batch slice bounds (host-side, one row per batch)."""

    kind: str  # 'events' or 'time'
    starts: np.ndarray  # slice starts (event idx or timestamp)
    batch_size: int  # slice width in events or graph ticks
    edge_counts: np.ndarray
    node_x_counts: Optional[np.ndarray]
    node_y_counts: Optional[np.ndarray]
    pad_edges: int
    pad_node_x: Optional[int]
    pad_node_y: Optional[int]
    # Per-batch start rows into each event-kind array (for device streams).
    edge_offsets: Optional[np.ndarray] = None
    node_x_offsets: Optional[np.ndarray] = None
    node_y_offsets: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.starts)


def _round_up(x: int, m: int) -> int:
    return max(m, int(math.ceil(x / m)) * m) if m > 1 else max(x, 1)


class DGDataLoader:
    """Iterate fixed-shape materialized batches of a ``DGraph`` on ``device``."""

    def __init__(
        self,
        dg: DGraph,
        batch_size: int = 1,
        batch_unit: str = "r",
        on_empty: Literal["skip", "raise", None] = "skip",
        hook_manager: Any = None,
        drop_last: bool = False,
        materialize_features: bool = True,
        pad_multiple: int = 8,
        device: DeviceLike = None,
    ) -> None:
        if batch_size <= 0:
            raise ValueError(f"batch_size must be > 0 but got {batch_size}")
        if on_empty not in ("skip", "raise", None):
            raise ValueError(f"Invalid on_empty={on_empty!r}")

        batch_td = TimeDeltaDG(batch_unit)
        if dg.time_delta.is_event_ordered and batch_td.is_time_ordered:
            raise EventOrderedConversionError(
                "Cannot iterate event-ordered dg using time-ordered batch_unit"
            )
        if dg.time_delta.is_time_ordered and batch_td.is_time_ordered:
            batch_td = TimeDeltaDG(batch_unit, value=batch_size)
            if dg.time_delta.is_coarser_than(batch_td):
                raise InvalidDiscretizationError(
                    f"DGraph time delta {dg.time_delta} is coarser than batch "
                    f"unit {batch_unit} x {batch_size}; pick a larger batch."
                )
            batch_size = int(batch_td.convert(dg.time_delta))

        self._dg = dg
        self._batch_size = batch_size
        self._hook_manager = hook_manager
        self._on_empty = on_empty
        self.materialize_features = materialize_features
        self.device = resolve_device(device)

        lo, hi = self._slice_index_bounds()
        if batch_td.is_event_ordered:
            kind, start, stop = "events", lo, hi
        else:
            kind, start, stop = "time", dg.start_time, dg.end_time + 1
        if drop_last:
            starts = np.arange(start, stop - batch_size, batch_size, dtype=np.int64)
        else:
            starts = np.arange(start, stop, batch_size, dtype=np.int64)
        self._plan = self._build_plan(kind, starts, batch_size, pad_multiple)

    def _slice_index_bounds(self):
        """This view's slice as global event-timeline index bounds."""
        data = self._dg._storage._data
        sl = self._dg._slice
        lo = sl.start_idx or 0
        hi = data.num_events if sl.end_idx is None else sl.end_idx
        if sl.start_time is not None:
            lo = max(lo, int(np.searchsorted(data.time, sl.start_time, "left")))
        if sl.end_time is not None:
            hi = min(hi, int(np.searchsorted(data.time, sl.end_time, "right")))
        return lo, hi

    def _build_plan(self, kind: str, starts: np.ndarray, batch_size: int,
                    pad_multiple: int) -> BatchPlan:
        data = self._dg._storage._data
        lo, hi = self._slice_index_bounds()
        if kind == "events":
            lbs = np.clip(starts, lo, hi)
            ubs = np.clip(starts + batch_size, lo, hi)
        else:
            lbs = np.clip(np.searchsorted(data.time, starts, "left"), lo, hi)
            ubs = np.clip(np.searchsorted(data.time, starts + batch_size, "left"), lo, hi)

        def window_bounds(mask: Optional[np.ndarray]):
            if mask is None:
                return None, None
            a = np.searchsorted(mask, lbs, "left")
            b = np.searchsorted(mask, ubs, "left")
            return a.astype(np.int64), (b - a).astype(np.int64)

        edge_offsets, edge_counts = window_bounds(data.edge_mask)
        node_x_offsets, node_x_counts = window_bounds(data.node_x_mask)
        node_y_offsets, node_y_counts = window_bounds(data.node_y_mask)
        pad = lambda c: None if c is None else _round_up(int(c.max(initial=0)), pad_multiple)
        return BatchPlan(
            kind=kind, starts=starts, batch_size=batch_size, edge_counts=edge_counts,
            node_x_counts=node_x_counts, node_y_counts=node_y_counts,
            pad_edges=pad(edge_counts), pad_node_x=pad(node_x_counts),
            pad_node_y=pad(node_y_counts), edge_offsets=edge_offsets,
            node_x_offsets=node_x_offsets, node_y_offsets=node_y_offsets,
        )

    def nonempty(self) -> np.ndarray:
        """Indices of the plan's batches with at least one event of any kind:
        the batches iteration yields unless ``on_empty`` is None."""
        p = self._plan
        total = p.edge_counts.copy()
        for counts in (p.node_x_counts, p.node_y_counts):
            if counts is not None:
                total += counts
        return np.flatnonzero(total > 0)

    def plan(self) -> BatchPlan:
        return self._plan

    @property
    def dgraph(self) -> DGraph:
        return self._dg

    @property
    def batch_size(self) -> int:
        return self._batch_size

    def __len__(self) -> int:
        return len(self._plan)

    def __iter__(self) -> Iterator[DGBatch]:
        p = self._plan
        kept = set(self.nonempty().tolist())
        for i, start in enumerate(p.starts):
            if i not in kept:
                if self._on_empty == "raise":
                    raise EmptyBatchError("Empty batch encountered")
                if self._on_empty == "skip":
                    continue

            if p.kind == "events":
                dg = self._dg.slice_events(int(start), int(start) + p.batch_size)
            else:
                dg = self._dg.slice_time(int(start), int(start) + p.batch_size)
            batch = dg.materialize(
                materialize_features=self.materialize_features,
                pad_edges_to=p.pad_edges,
                pad_node_x_to=p.pad_node_x,
                pad_node_y_to=p.pad_node_y,
                device=self.device,
            )
            if self._hook_manager is not None:
                batch = self._hook_manager.execute_active_hooks(dg, batch)
            yield batch
