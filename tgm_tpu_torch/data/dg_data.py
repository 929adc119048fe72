"""Validated host-side container for temporal graph events.

Port of ``tgm_tpu/data/dg_data.py``: edge events, dynamic node-feature
events (``node_x_*``) and node-label events (``node_y_*``), edge and node
types; ``DGData.from_raw`` with its validation, the sorted unified timeline
(a stable sort keeps edges, then node features, then labels at equal
times), ``split()``, ``discretize()``, ``clone()``, ``num_nodes``,
``edge_x``, ``static_node_x`` and ``edge_global_offset``; the pandas and
CSV constructors (``from_pandas``, ``from_csv``) and the TGB and TGB-Seq
loaders (``from_tgb``, ``from_tgb_seq``, in ``data/tgb.py``). Everything
here is numpy on the host; device upload happens once, in
``train.stream``.
"""

from __future__ import annotations

import copy
import pathlib
import warnings
from dataclasses import dataclass, fields, replace
from typing import Any, List, Optional, Tuple, Union

import numpy as np

from ..constants import PADDED_NODE_ID
from ..exceptions import (
    EmptyGraphError,
    EventOrderedConversionError,
    InvalidDiscretizationError,
    InvalidNodeIDError,
)
from ..native import stable_sort_perm
from ..timedelta import TimeDeltaDG
from ..util.logging import log_latency

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
    """Edge, node-feature and node-label events of a dynamic graph, sorted by time.

    ``time`` is the sorted int64 timeline of every event; ``edge_mask``,
    ``node_x_mask`` and ``node_y_mask`` index each kind's events in it.
    """

    time_delta: Union[TimeDeltaDG, str]
    time: np.ndarray  # [num_events] int64, sorted
    edge_mask: np.ndarray  # [num_edge_events] int32 indices into `time`
    edge_index: np.ndarray  # [num_edge_events, 2] int32
    edge_x: Optional[np.ndarray] = None  # [num_edge_events, D_edge] float32

    node_x_mask: Optional[np.ndarray] = None  # [num_node_events] int32
    node_x_nids: Optional[np.ndarray] = None  # [num_node_events] int32
    node_x: Optional[np.ndarray] = None  # [num_node_events, D_node] float32

    node_y_mask: Optional[np.ndarray] = None  # [num_node_labels] int32
    node_y_nids: Optional[np.ndarray] = None  # [num_node_labels] int32
    node_y: Optional[np.ndarray] = None  # [num_node_labels, D_label] float32

    static_node_x: Optional[np.ndarray] = None  # [num_nodes, D_static] float32
    edge_type: Optional[np.ndarray] = None  # [num_edge_events] int32
    node_type: Optional[np.ndarray] = None  # [num_nodes] int32

    _split_strategy: Any = None

    # Row of this data's first edge inside the pre-split parent dataset (set
    # by split strategies, whose selections are contiguous). Per-split streams
    # emit GLOBAL edge ids so one full-dataset feature table serves every split.
    edge_global_offset: int = 0

    def __post_init__(self) -> None:
        if isinstance(self.time_delta, str):
            self.time_delta = TimeDeltaDG(self.time_delta)
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

        num_node_events = self._validate_node_triplet("node_x")
        num_node_labels = self._validate_node_triplet("node_y")
        # Node-feature ids widen the node range, labels do not: a label id
        # at or past the range raises.
        num_nodes = self.num_nodes
        if self.node_y_nids is not None and int(self.node_y_nids.max()) + 1 > num_nodes:
            raise InvalidNodeIDError(
                "Node labels reference node IDs outside the graph's node ID range: "
                f"{int(self.node_y_nids.max()) + 1} > {num_nodes}"
            )

        if self.static_node_x is not None:
            self.static_node_x = _as_array(self.static_node_x, "static_node_x")
            if self.static_node_x.ndim != 2:
                raise ValueError(
                    f"static_node_x must be 2D [N, D_static], got shape {self.static_node_x.shape}"
                )
            if self.static_node_x.shape[0] < num_nodes:
                raise ValueError(
                    f"static_node_x has {self.static_node_x.shape[0]} rows but data requires "
                    f">= {num_nodes}"
                )
            self.static_node_x = _to_float32(self.static_node_x, "static_node_x")

        if self.edge_type is not None:
            self.edge_type = _as_array(self.edge_type, "edge_type")
            _require_integral(self.edge_type, "edge_type")
            if self.edge_type.ndim != 1 or self.edge_type.shape[0] != num_edges:
                raise ValueError(
                    f"edge_type must have shape [num_edges], got {self.edge_type.shape}")
            self.edge_type = _to_int32(self.edge_type, "edge_type")

        if self.node_type is not None:
            self.node_type = _as_array(self.node_type, "node_type")
            _require_integral(self.node_type, "node_type")
            if self.node_type.ndim != 1 or self.node_type.shape[0] < num_nodes:
                raise ValueError(
                    f"node_type must have shape [num_nodes], got {self.node_type.shape}")
            self.node_type = _to_int32(self.node_type, "node_type")

        expected = num_edges + num_node_events + num_node_labels
        if self.time.ndim != 1 or self.time.shape[0] != expected:
            raise ValueError(
                f"time must have shape [{expected}] (edges {num_edges} + node events "
                f"{num_node_events} + node labels {num_node_labels}), got {self.time.shape}"
            )
        self._sort_if_needed()

    def _validate_node_triplet(self, prefix: str) -> int:
        """Check and normalise one kind of node events (``{prefix}_mask``,
        ``{prefix}_nids``, ``{prefix}``, ``prefix`` "node_x" or "node_y");
        returns their number (0 without a mask)."""
        mask = getattr(self, f"{prefix}_mask")
        if mask is None:
            return 0
        mask = _as_array(mask, f"{prefix}_mask")
        _require_integral(mask, f"{prefix}_mask")
        setattr(self, f"{prefix}_mask", mask.astype(np.int32))
        n = mask.shape[0]
        if n == 0:
            raise ValueError(f"{prefix}_mask is an empty array; double-check your inputs")

        nids = getattr(self, f"{prefix}_nids")
        if nids is None:
            raise ValueError(f"{prefix}_mask given without {prefix}_nids")
        nids = _as_array(nids, f"{prefix}_nids")
        _require_integral(nids, f"{prefix}_nids")
        if nids.ndim != 1 or nids.shape[0] != n:
            raise ValueError(f"{prefix}_nids must have shape [{n}], got {nids.shape}")
        if np.any(nids == PADDED_NODE_ID):
            raise InvalidNodeIDError(
                f"{prefix}_nids contains node ids matching PADDED_NODE_ID ({PADDED_NODE_ID})"
            )
        if int(nids.max()) >= _INT32_MAX:
            raise InvalidNodeIDError(f"{prefix}_nids exceed the int32 limit")
        setattr(self, f"{prefix}_nids", _to_int32(nids, f"{prefix}_nids"))

        feats = getattr(self, prefix)
        if feats is not None:
            feats = _as_array(feats, prefix)
            if feats.ndim != 2 or feats.shape[0] != n:
                raise ValueError(f"{prefix} must have shape [{n}, D], got {feats.shape}")
            setattr(self, prefix, _to_float32(feats, prefix))
        return n

    def _sort_if_needed(self) -> None:
        """Sort the timeline stably (equal times keep their order: edges,
        then node features, then labels) and each kind's rows by their new
        positions."""
        if np.all(np.diff(self.time) >= 0):
            return
        sort_idx = stable_sort_perm(self.time).astype(np.int32)
        inverse = np.empty_like(sort_idx)
        inverse[sort_idx] = np.arange(len(sort_idx), dtype=np.int32)
        self.time = self.time[sort_idx]

        self.edge_mask = inverse[self.edge_mask]
        order = np.argsort(self.edge_mask, kind="stable")
        self.edge_mask = self.edge_mask[order]
        self.edge_index = self.edge_index[order]
        if self.edge_x is not None:
            self.edge_x = self.edge_x[order]
        if self.edge_type is not None:
            self.edge_type = self.edge_type[order]

        for prefix in ("node_x", "node_y"):
            mask = getattr(self, f"{prefix}_mask")
            if mask is None:
                continue
            mask = inverse[mask]
            order = np.argsort(mask, kind="stable")
            setattr(self, f"{prefix}_mask", mask[order])
            setattr(self, f"{prefix}_nids", getattr(self, f"{prefix}_nids")[order])
            feats = getattr(self, prefix)
            if feats is not None:
                setattr(self, prefix, feats[order])

    @property
    def edge_time(self) -> np.ndarray:
        return self.time[self.edge_mask]

    @property
    def node_x_time(self) -> Optional[np.ndarray]:
        return None if self.node_x_mask is None else self.time[self.node_x_mask]

    @property
    def node_y_time(self) -> Optional[np.ndarray]:
        return None if self.node_y_mask is None else self.time[self.node_y_mask]

    @property
    def num_nodes(self) -> int:
        """Edge and node-feature ids: labels never widen the range."""
        max_id = int(self.edge_index.max())
        if self.node_x_nids is not None:
            max_id = max(max_id, int(self.node_x_nids.max()))
        return max_id + 1

    @property
    def num_edge_events(self) -> int:
        return self.edge_index.shape[0]

    @property
    def num_events(self) -> int:
        return self.time.shape[0]

    def split(self, strategy: Any = None) -> Tuple["DGData", ...]:
        """Split into train/val/test (default: 70/15/15 ``TemporalRatioSplit``).

        A TGB strategy attached to the data cannot be overridden.
        """
        from .split import TemporalRatioSplit, TGBSplit

        strategy = strategy or self._split_strategy or TemporalRatioSplit()
        if isinstance(self._split_strategy, TGBSplit) and strategy is not self._split_strategy:
            raise ValueError("Cannot override split strategy for TGB datasets")
        return strategy.apply(self)

    @log_latency
    def discretize(self, time_delta: Union[TimeDeltaDG, str, None],
                   reduce_op: str = "first") -> "DGData":
        """Coarsen the timeline into buckets of ``time_delta``.

        Of the events of one kind that share a bucket and an entity (the
        (src, dst) pair of an edge, the node of a node-feature or label
        event), only the first in
        the timeline survives, with its features. One stable lexsort a kind,
        on the int64 key ``src * (max_id + 1) + dst`` for edges. The result
        has ``time_delta`` and the bucket indices as its times; the same
        ``time_delta`` (or None) gives a clone.
        """
        if isinstance(time_delta, str):
            time_delta = TimeDeltaDG(time_delta)
        if time_delta is None or self.time_delta == time_delta:
            return self.clone()
        if self.time_delta.is_event_ordered or time_delta.is_event_ordered:
            raise EventOrderedConversionError(
                "Cannot discretize a graph with event-ordered time granularity"
            )
        if self.time_delta.is_coarser_than(time_delta):
            raise InvalidDiscretizationError(
                f"Cannot discretize to {time_delta}, which is strictly finer than {self.time_delta}"
            )
        if reduce_op != "first":
            raise ValueError(f"Unknown reduce_op: {reduce_op!r}, expected 'first'")

        factor = self.time_delta.convert(time_delta)
        buckets = np.floor(self.time.astype(np.float64) * factor).astype(np.int64)

        def keep_first(event_idx: np.ndarray, ids: np.ndarray) -> np.ndarray:
            """Sorted rows (of ``ids``) that are the first of their (bucket, key)."""
            b = buckets[event_idx]
            if ids.ndim == 2:
                base = np.int64(ids.max()) + 1
                key = ids[:, 0].astype(np.int64) * base + ids[:, 1].astype(np.int64)
            else:
                key = ids.astype(np.int64)
            order = np.lexsort((key, b))
            bb, kk = b[order], key[order]
            first = np.ones(len(order), dtype=bool)
            first[1:] = (bb[1:] != bb[:-1]) | (kk[1:] != kk[:-1])
            keep = order[first]
            keep.sort()
            return keep

        ek = keep_first(self.edge_mask, self.edge_index)
        node_kwargs = {}
        for prefix in ("node_x", "node_y"):
            mask = getattr(self, f"{prefix}_mask")
            if mask is None:
                continue
            nids = getattr(self, f"{prefix}_nids")
            nk = keep_first(mask, nids)
            feats = getattr(self, prefix)
            node_kwargs.update({f"{prefix}_time": buckets[mask][nk], f"{prefix}_nids": nids[nk],
                                prefix: None if feats is None else feats[nk]})
        return DGData.from_raw(
            time_delta=time_delta,
            edge_time=buckets[self.edge_mask][ek],
            edge_index=self.edge_index[ek],
            edge_x=None if self.edge_x is None else self.edge_x[ek],
            static_node_x=None if self.static_node_x is None else self.static_node_x.copy(),
            edge_type=None if self.edge_type is None else self.edge_type[ek],
            node_type=None if self.node_type is None else self.node_type.copy(),
            **node_kwargs,
        )

    def clone(self) -> "DGData":
        """A deep copy: every array copied, every other field deep-copied."""
        cloned = {}
        for f in fields(self):
            v = getattr(self, f.name)
            cloned[f.name] = v.copy() if isinstance(v, np.ndarray) else copy.deepcopy(v)
        return replace(self, **cloned)

    @classmethod
    def from_raw(
        cls,
        edge_time: np.ndarray,
        edge_index: np.ndarray,
        edge_x: Optional[np.ndarray] = None,
        node_x_time: Optional[np.ndarray] = None,
        node_x_nids: Optional[np.ndarray] = None,
        node_x: Optional[np.ndarray] = None,
        node_y_time: Optional[np.ndarray] = None,
        node_y_nids: Optional[np.ndarray] = None,
        node_y: Optional[np.ndarray] = None,
        static_node_x: Optional[np.ndarray] = None,
        time_delta: Union[TimeDeltaDG, str] = "r",
        edge_type: Optional[np.ndarray] = None,
        node_type: Optional[np.ndarray] = None,
    ) -> "DGData":
        """Build the sorted timeline from per-kind event times: the edges,
        then the node-feature events, then the labels, concatenated; the
        masks locate each kind in it."""
        edge_time = _as_array(edge_time, "edge_time")
        parts = [edge_time]
        masks = {}
        for prefix, t in (("node_x", node_x_time), ("node_y", node_y_time)):
            if t is not None:
                t = _as_array(t, f"{prefix}_time")
                start = sum(len(p) for p in parts)
                masks[f"{prefix}_mask"] = start + np.arange(len(t))
                parts.append(t)
        return cls(
            time_delta=time_delta,
            time=np.concatenate(parts),
            edge_mask=np.arange(len(edge_time)),
            edge_index=edge_index,
            edge_x=edge_x,
            node_x_nids=node_x_nids,
            node_x=node_x,
            node_y_nids=node_y_nids,
            node_y=node_y,
            static_node_x=static_node_x,
            edge_type=edge_type,
            node_type=node_type,
            **masks,
        )

    @classmethod
    def from_pandas(
        cls,
        edge_df,
        edge_src_col: str,
        edge_dst_col: str,
        edge_time_col: str,
        edge_x_col: Optional[List[str]] = None,
        node_x_df=None,
        node_x_nids_col: Optional[str] = None,
        node_x_time_col: Optional[str] = None,
        node_x_col: Optional[List[str]] = None,
        node_y_df=None,
        node_y_nids_col: Optional[str] = None,
        node_y_time_col: Optional[str] = None,
        node_y_col: Optional[List[str]] = None,
        static_node_x_df=None,
        static_node_x_col: Optional[List[str]] = None,
        time_delta: Union[TimeDeltaDG, str] = "r",
        edge_type_col: Optional[str] = None,
        node_type_col: Optional[str] = None,
    ) -> "DGData":
        """Build from data frames: anything whose ``df[col].to_numpy(dtype)``
        gives a column (or, for a list of names, a 2-D block); pandas itself
        is not imported."""
        edge_index = np.stack([edge_df[edge_src_col].to_numpy(np.int64),
                               edge_df[edge_dst_col].to_numpy(np.int64)], axis=1)
        edge_time = edge_df[edge_time_col].to_numpy(np.int64)
        edge_x = None if edge_x_col is None else edge_df[edge_x_col].to_numpy(np.float32)
        edge_type = None if edge_type_col is None else edge_df[edge_type_col].to_numpy(np.int64)

        def node_triplet(df, nids_col, time_col, feat_cols, what):
            if df is None:
                return None, None, None
            if nids_col is None or time_col is None:
                raise ValueError(f"specified {what} df without node id / time columns")
            x = None if feat_cols is None else df[feat_cols].to_numpy(np.float32)
            return df[time_col].to_numpy(np.int64), df[nids_col].to_numpy(np.int64), x

        node_x_time, node_x_nids, node_x = node_triplet(
            node_x_df, node_x_nids_col, node_x_time_col, node_x_col, "node_x")
        node_y_time, node_y_nids, node_y = node_triplet(
            node_y_df, node_y_nids_col, node_y_time_col, node_y_col, "node_y")

        static_node_x = node_type = None
        if static_node_x_df is not None:
            if static_node_x_col is None and node_type_col is None:
                raise ValueError(
                    "specified static_node_x_df without static_node_x_col / node_type_col")
            if static_node_x_col is not None:
                static_node_x = static_node_x_df[static_node_x_col].to_numpy(np.float32)
            if node_type_col is not None:
                node_type = static_node_x_df[node_type_col].to_numpy(np.int64)

        return cls.from_raw(
            time_delta=time_delta, edge_time=edge_time, edge_index=edge_index, edge_x=edge_x,
            node_x_time=node_x_time, node_x_nids=node_x_nids, node_x=node_x,
            node_y_time=node_y_time, node_y_nids=node_y_nids, node_y=node_y,
            static_node_x=static_node_x, edge_type=edge_type, node_type=node_type,
        )

    @classmethod
    def from_csv(
        cls,
        edge_file_path: Union[str, pathlib.Path],
        edge_src_col: str,
        edge_dst_col: str,
        edge_time_col: str,
        edge_x_col: Optional[List[str]] = None,
        node_x_file_path: Optional[Union[str, pathlib.Path]] = None,
        node_x_nids_col: Optional[str] = None,
        node_x_time_col: Optional[str] = None,
        node_x_col: Optional[List[str]] = None,
        node_y_file_path: Optional[Union[str, pathlib.Path]] = None,
        node_y_nids_col: Optional[str] = None,
        node_y_time_col: Optional[str] = None,
        node_y_col: Optional[List[str]] = None,
        static_node_x_file_path: Optional[Union[str, pathlib.Path]] = None,
        static_node_x_col: Optional[List[str]] = None,
        time_delta: Union[TimeDeltaDG, str] = "r",
        edge_type_col: Optional[str] = None,
        node_type_col: Optional[str] = None,
    ) -> "DGData":
        """Build from CSV files with pandas' reader (``from_pandas`` on the
        frames). pandas is imported here only: the rest of the package runs
        without it."""
        import pandas as pd

        def maybe_read(p):
            return None if p is None else pd.read_csv(str(p))

        return cls.from_pandas(
            edge_df=pd.read_csv(str(edge_file_path)), edge_src_col=edge_src_col,
            edge_dst_col=edge_dst_col, edge_time_col=edge_time_col, edge_x_col=edge_x_col,
            node_x_df=maybe_read(node_x_file_path), node_x_nids_col=node_x_nids_col,
            node_x_time_col=node_x_time_col, node_x_col=node_x_col,
            node_y_df=maybe_read(node_y_file_path), node_y_nids_col=node_y_nids_col,
            node_y_time_col=node_y_time_col, node_y_col=node_y_col,
            static_node_x_df=maybe_read(static_node_x_file_path),
            static_node_x_col=static_node_x_col, time_delta=time_delta,
            edge_type_col=edge_type_col, node_type_col=node_type_col,
        )

    @classmethod
    def from_tgb(cls, name: str, time_delta: Union[TimeDeltaDG, str, None] = None,
                 **kwargs) -> "DGData":
        """A TGB dataset (tgbl-, tgbn-, tkgl-, thgl-) from the optional
        ``py-tgb`` package, with its official split as a ``TGBSplit``."""
        from .tgb import load_tgb

        return load_tgb(cls, name, time_delta=time_delta, **kwargs)

    @classmethod
    def from_tgb_seq(cls, name: str, time_delta: Union[TimeDeltaDG, str, None] = None,
                     **kwargs) -> "DGData":
        """A TGB-Seq dataset from the optional ``tgb-seq`` package, with its
        official split as a ``TGBSplit``."""
        from .tgb import load_tgb_seq

        return load_tgb_seq(cls, name, time_delta=time_delta, **kwargs)
