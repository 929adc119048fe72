"""Immutable dynamic-graph view (port of ``tgm_tpu/core/graph.py``).

Slicing by event index (``slice_events``) or timestamp (``slice_time``,
end-exclusive), ``materialize()`` of a slice into a ``DGBatch`` padded to
static widths (edges, global ``edge_ids``, ``edge_x``, ``edge_type``, the
node-feature and the node-label events), and the slice's properties (host
numpy arrays and counts). The uniform sampler's temporal CSR lives in the
storage (``temporal_csr``).
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Optional, Tuple

import numpy as np
import torch

from ..constants import PADDED_NODE_ID
from ..device import DeviceLike, resolve_device
from ..timedelta import TimeDeltaDG
from ..util.logging import log_latency
from ._storage import DGSliceTracker, DGStorage
from .batch import DGBatch


def pad_rows(x: np.ndarray, width: Optional[int], fill) -> Tuple[np.ndarray, np.ndarray]:
    """``x`` padded with ``fill`` to ``width`` rows, and the mask of its real rows."""
    n = x.shape[0]
    if width is None or width == n:
        return x, np.ones(n, dtype=bool)
    if width < n:
        raise ValueError(f"pad width {width} < actual size {n}")
    out = np.full((width,) + x.shape[1:], fill, dtype=x.dtype)
    out[:n] = x
    valid = np.zeros(width, dtype=bool)
    valid[:n] = True
    return out, valid


class DGraph:
    """A sliceable view of one ``DGData``."""

    def __init__(self, data: "DGData") -> None:
        from ..data.dg_data import DGData

        if not isinstance(data, DGData):
            raise TypeError(f"DGraph must be initialized with DGData, got {type(data)}")
        self._time_delta = data.time_delta
        self._storage = DGStorage(data)
        self._slice = DGSliceTracker()

    # ------------------------------------------------------------------ #
    def slice_events(self, start_idx: Optional[int] = None,
                     end_idx: Optional[int] = None) -> "DGraph":
        """View restricted to global event indices [start_idx, end_idx)."""
        if start_idx is not None and end_idx is not None and start_idx > end_idx:
            raise ValueError(f"start_idx ({start_idx}) must be <= end_idx ({end_idx})")
        s = self._slice
        return self._view(dataclasses.replace(
            s, start_idx=_maybe_max(start_idx, s.start_idx),
            end_idx=_maybe_min(end_idx, s.end_idx)))

    def slice_time(self, start_time: Optional[int] = None,
                   end_time: Optional[int] = None) -> "DGraph":
        """View restricted to timestamps [start_time, end_time)."""
        if start_time is not None and end_time is not None and start_time > end_time:
            raise ValueError(f"start_time ({start_time}) must be <= end_time ({end_time})")
        if end_time is not None:
            end_time -= 1  # storage bounds are inclusive
        s = self._slice
        return self._view(dataclasses.replace(
            s, start_time=_maybe_max(start_time, s.start_time),
            end_time=_maybe_min(end_time, s.end_time)))

    def _view(self, sl: DGSliceTracker) -> "DGraph":
        obj = DGraph.__new__(DGraph)
        obj._storage = self._storage
        obj._time_delta = self._time_delta
        obj._slice = sl
        return obj

    # ------------------------------------------------------------------ #
    @log_latency
    def materialize(
        self,
        materialize_features: bool = True,
        pad_edges_to: Optional[int] = None,
        pad_node_x_to: Optional[int] = None,
        pad_node_y_to: Optional[int] = None,
        device: DeviceLike = None,
    ) -> DGBatch:
        """This slice as a ``DGBatch`` on ``device``.

        With ``pad_*_to`` widths the batch has static shapes: padded slots
        hold ``PADDED_NODE_ID`` / 0 (``edge_ids`` -1) and are invalid in
        ``edge_valid`` / ``node_x_valid`` / ``node_y_valid``. ``edge_ids``
        are global: the slice's rows offset by the split's place in the
        pre-split dataset. ``materialize_features=False`` leaves out
        ``edge_x`` and the node-feature and label events; ``edge_type`` is
        there either way. With labels materialized the batch also carries
        ``num_node_labels``, the host count of its real labels.
        """
        dev = resolve_device(device)
        up = lambda x: torch.as_tensor(x, device=dev)
        src, dst, time = self._storage.get_edges(self._slice)
        n_real = len(src)
        src, _ = pad_rows(src, pad_edges_to, PADDED_NODE_ID)
        dst, _ = pad_rows(dst, pad_edges_to, PADDED_NODE_ID)
        time, edge_valid = pad_rows(time.astype(np.int32), pad_edges_to, 0)
        batch = DGBatch(up(src.astype(np.int32)), up(dst.astype(np.int32)), up(time),
                        up(edge_valid))
        rows = self._storage.get_edge_rows(self._slice)
        ids = np.full(len(src), -1, np.int32)
        ids[:n_real] = (rows.start + self._storage._data.edge_global_offset
                        + np.arange(n_real, dtype=np.int32))
        batch.edge_ids = up(ids)

        def node_events(triplet, width):
            t, nids, feats = triplet
            t, _ = pad_rows(t.astype(np.int32), width, 0)
            nids, valid = pad_rows(nids, width, PADDED_NODE_ID)
            feats, _ = pad_rows(feats, width, 0.0)
            return up(t), up(nids.astype(np.int32)), up(feats), up(valid)

        if materialize_features:
            node_x = self._storage.get_node_x(self._slice)
            if node_x is not None:
                (batch.node_x_time, batch.node_x_nids, batch.node_x,
                 batch.node_x_valid) = node_events(node_x, pad_node_x_to)
            if self.edge_x_dim is not None:
                ex, _ = pad_rows(self._storage.get_edge_x(self._slice), pad_edges_to, 0.0)
                batch.edge_x = up(ex)
            node_y = self._storage.get_node_y(self._slice)
            if node_y is not None:
                batch.num_node_labels = len(node_y[1])
                (batch.node_y_time, batch.node_y_nids, batch.node_y,
                 batch.node_y_valid) = node_events(node_y, pad_node_y_to)
        edge_type = self._storage.get_edge_type(self._slice)
        if edge_type is not None:
            batch.edge_type = up(pad_rows(edge_type, pad_edges_to, 0)[0].astype(np.int32))
        return batch

    # ------------------------------------------------------------------ #
    @property
    def time_delta(self) -> TimeDeltaDG:
        return self._time_delta

    @cached_property
    def start_time(self) -> Optional[int]:
        return self._storage.get_start_time(self._slice)

    @cached_property
    def end_time(self) -> Optional[int]:
        return self._storage.get_end_time(self._slice)

    @cached_property
    def num_nodes(self) -> int:
        nodes = self._storage.get_nodes(self._slice)
        return max(nodes) + 1 if nodes else 0

    @cached_property
    def num_edge_events(self) -> int:
        return len(self.edge_dst)

    @cached_property
    def num_node_events(self) -> int:
        return len(self.node_x_nids)

    @cached_property
    def num_node_labels(self) -> int:
        return len(self.node_y_nids)

    @cached_property
    def num_timestamps(self) -> int:
        return self._storage.get_num_timestamps(self._slice)

    @cached_property
    def num_events(self) -> int:
        return self._storage.get_num_events(self._slice)

    @cached_property
    def _edges(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self._storage.get_edges(self._slice)

    @property
    def edge_src(self) -> np.ndarray:
        return self._edges[0]

    @property
    def edge_dst(self) -> np.ndarray:
        return self._edges[1]

    @property
    def edge_time(self) -> np.ndarray:
        return self._edges[2]

    @cached_property
    def edge_x(self) -> Optional[np.ndarray]:
        return self._storage.get_edge_x(self._slice)

    @cached_property
    def edge_type(self) -> Optional[np.ndarray]:
        return self._storage.get_edge_type(self._slice)

    @cached_property
    def _node_events(self) -> Tuple[np.ndarray, np.ndarray]:
        return self._storage.get_node_events(self._slice)

    @property
    def node_x_nids(self) -> np.ndarray:
        return self._node_events[0]

    @property
    def node_x_time(self) -> np.ndarray:
        return self._node_events[1]

    @cached_property
    def node_x(self) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """The slice's node-feature events as a (time, nids, feats) triplet."""
        return self._storage.get_node_x(self._slice)

    @cached_property
    def _node_labels(self) -> Tuple[np.ndarray, np.ndarray]:
        return self._storage.get_node_labels(self._slice)

    @property
    def node_y_nids(self) -> np.ndarray:
        return self._node_labels[0]

    @property
    def node_y_time(self) -> np.ndarray:
        return self._node_labels[1]

    @cached_property
    def node_y(self) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """The slice's labels as a (time, nids, labels) triplet."""
        return self._storage.get_node_y(self._slice)

    @cached_property
    def static_node_x(self) -> Optional[np.ndarray]:
        return self._storage.get_static_node_x()

    @cached_property
    def node_type(self) -> Optional[np.ndarray]:
        return self._storage.get_node_type()

    @cached_property
    def static_node_x_dim(self) -> Optional[int]:
        return self._storage.get_static_node_x_dim()

    @cached_property
    def node_x_dim(self) -> Optional[int]:
        return self._storage.get_node_x_dim()

    @cached_property
    def node_y_dim(self) -> Optional[int]:
        return self._storage.get_node_y_dim()

    @cached_property
    def edge_x_dim(self) -> Optional[int]:
        return self._storage.get_edge_x_dim()


def _maybe_max(a: Optional[int], b: Optional[int]) -> Optional[int]:
    if a is not None and b is not None:
        return max(a, b)
    return a if b is None else b


def _maybe_min(a: Optional[int], b: Optional[int]) -> Optional[int]:
    if a is not None and b is not None:
        return min(a, b)
    return a if b is None else b
