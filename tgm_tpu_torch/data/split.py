"""Temporal dataset split strategies (port of ``tgm_tpu/data/split.py``).

``TemporalSplit`` (absolute boundaries, [start, end) per split, for edges,
node-feature events and labels), ``TemporalRatioSplit`` (ratios of the
time span) and ``TGBSplit`` (inclusive per-split edge-time bounds; labels
in ``[start - 1, end)``, every node-feature event in each split). A split
whose node-feature or label events are all masked out drops that kind and
logs a warning; ``static_node_x`` and ``node_type`` are shared, not
copied.
"""

from __future__ import annotations

import logging
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, Optional, Tuple

import numpy as np

if TYPE_CHECKING:  # pragma: no cover
    from .dg_data import DGData

logger = logging.getLogger(__name__)


class SplitStrategy(ABC):
    """Base class: defines how a ``DGData`` is divided into temporal subsets."""

    @abstractmethod
    def apply(self, data: "DGData") -> Tuple["DGData", ...]:
        raise NotImplementedError

    def _masked_copy(self, data: "DGData", edge_mask: np.ndarray,
                     node_x_mask: Optional[np.ndarray] = None,
                     node_y_mask: Optional[np.ndarray] = None) -> "DGData":
        from .dg_data import DGData

        kwargs = {}
        for prefix, mask in (("node_x", node_x_mask), ("node_y", node_y_mask)):
            nids = getattr(data, f"{prefix}_nids")
            if nids is None:
                continue
            if mask is None:
                mask = np.ones(nids.shape[0], dtype=bool)
            if not mask.any():
                logger.warning("All %s events masked out; dropping from split", prefix)
                continue
            feats = getattr(data, prefix)
            kwargs.update({f"{prefix}_nids": nids[mask],
                           f"{prefix}_time": data.time[getattr(data, f"{prefix}_mask")[mask]],
                           prefix: None if feats is None else feats[mask]})
        out = DGData.from_raw(
            time_delta=data.time_delta,
            edge_time=data.time[data.edge_mask[edge_mask]],
            edge_index=data.edge_index[edge_mask],
            edge_x=None if data.edge_x is None else data.edge_x[edge_mask],
            static_node_x=data.static_node_x,  # shared, not copied
            edge_type=None if data.edge_type is None else data.edge_type[edge_mask],
            node_type=data.node_type,  # shared, not copied
            **kwargs,
        )
        # Where this split's edges live in the parent's row space (temporal
        # splits select contiguous runs; anything else keeps 0).
        idx = np.flatnonzero(edge_mask)
        if idx.size and int(idx[-1]) - int(idx[0]) + 1 == idx.size:
            out.edge_global_offset = data.edge_global_offset + int(idx[0])
        return out


@dataclass
class TemporalSplit(SplitStrategy):
    """Train (-inf, val_time), val [val_time, test_time), test [test_time, inf)."""

    val_time: int
    test_time: int

    def __post_init__(self) -> None:
        if not (0 <= self.val_time <= self.test_time):
            raise ValueError(
                f"Expected 0 <= val_time <= test_time, got {self.val_time}, {self.test_time}"
            )

    def apply(self, data: "DGData") -> Tuple["DGData", ...]:
        edge_times = data.edge_time
        node_x_times = data.node_x_time
        node_y_times = data.node_y_time
        ranges = {"train": (-np.inf, self.val_time), "val": (self.val_time, self.test_time),
                  "test": (self.test_time, np.inf)}
        in_range = lambda t, a, b: None if t is None else (t >= a) & (t < b)
        splits = []
        for name, (start, end) in ranges.items():
            edge_mask = (edge_times >= start) & (edge_times < end)
            if not edge_mask.any():
                logger.warning("No edges in %s split range [%s, %s)", name, start, end)
                continue
            splits.append(self._masked_copy(data, edge_mask, in_range(node_x_times, start, end),
                                            in_range(node_y_times, start, end)))
        return tuple(splits)


@dataclass
class TemporalRatioSplit(SplitStrategy):
    """Ratio split over the total time span (default 0.7/0.15/0.15)."""

    train_ratio: float = 0.7
    val_ratio: float = 0.15
    test_ratio: float = 0.15

    def __post_init__(self) -> None:
        if min(self.train_ratio, self.val_ratio, self.test_ratio) < 0:
            raise ValueError("Ratios must all be non-negative")
        total = self.train_ratio + self.val_ratio + self.test_ratio
        if abs(total - 1.0) > 1e-6:
            raise ValueError(f"Ratios must sum to 1.0, got {total}")

    def apply(self, data: "DGData") -> Tuple["DGData", ...]:
        min_time, max_time = int(data.time[0]), int(data.time[-1])
        span = max_time - min_time + 1
        val_time = min_time + int(span * self.train_ratio)
        test_time = val_time + int(span * self.val_ratio)
        return TemporalSplit(val_time=val_time, test_time=test_time).apply(data)


@dataclass
class TGBSplit(SplitStrategy):
    """Official TGB split with inclusive per-split edge-time bounds."""

    split_bounds: Dict[str, Tuple[int, int]]

    def apply(self, data: "DGData") -> Tuple["DGData", "DGData", "DGData"]:
        edge_times = data.edge_time
        node_y_times = data.node_y_time
        splits = []
        for name in ("train", "val", "test"):
            start, end = self.split_bounds[name]
            edge_mask = (edge_times >= start) & (edge_times <= end)
            node_y_mask = None
            if node_y_times is not None and edge_mask.any():
                # TGB convention: labels attach to the window that starts one
                # tick before the split's first edge, and end before ``end``.
                node_y_mask = (node_y_times >= (start - 1)) & (node_y_times < end)
            splits.append(self._masked_copy(data, edge_mask, None, node_y_mask))
        return tuple(splits)
