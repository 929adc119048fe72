"""Time-gap neighbour mean hook (port of ``tgm_tpu/hooks/timegap.py``).

For every seed node, the neighbours in the last ``time_gap`` EVENTS
strictly before the batch (GraphMixer's node encoder): the window is the
events of split-local index in ``[batch_end_idx - time_gap,
batch_end_idx)`` with ``time <= batch.min_time - 1``, and the hook produces
the mean of their static node features, weighted by multiplicity, zero for
a seed without window neighbours. The window is a fixed-width slice of the
split's event arrays (padded with sentinel rows so any start slices in
bounds) and the mean two ``(S, G)`` equality-mask matmuls, summed in fp64
and rounded to fp32 once, so every device gives the same means.

The hook is registered once per key (per split): the window index space is
local to the split, so each split's hook takes that split's arrays.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..core.batch import DGBatch
from ..core.graph import DGraph
from ..device import DeviceLike, resolve_device
from .base import SeedableHook
from .registry import hook

_INT32_MAX = int(np.iinfo(np.int32).max)


@hook
class TimeGapNeighborMeanHook(SeedableHook):
    """Mean static node features of each seed's last-``time_gap``-events
    neighbours (multiplicity-weighted; zero when the window has none).

    Produces ``time_gap_feat`` (S, d) and ``time_gap_count`` (S,) where S is
    the concatenation of the ``seed_nodes_keys`` batch attributes.
    ``edge_*_full`` are the SPLIT's own event arrays; ``edge_id_base`` is the
    split's global edge-id offset (``DGData.edge_global_offset``), so the
    batches' global ``edge_ids`` localize.
    """

    has_state = False
    _cls_requires = {"edge_src", "edge_dst", "edge_time", "edge_ids"}
    _cls_produces = {"time_gap_feat", "time_gap_count"}

    def __init__(
        self,
        edge_src_full: Any,
        edge_dst_full: Any,
        edge_time_full: Any,
        node_x: Any,
        time_gap: int,
        seed_nodes_keys: List[str],
        edge_id_base: int = 0,
        device: DeviceLike = None,
        id: Optional[str] = None,
    ) -> None:
        if time_gap < 1:
            raise ValueError(f"time_gap must be >= 1, got {time_gap}")
        super().__init__(seed_keys=list(seed_nodes_keys), id=id)
        dev = resolve_device(device)
        G = self._G = int(time_gap)
        self._base = int(edge_id_base)
        src = np.asarray(edge_src_full, np.int32)
        self._E = len(src)
        self._node_x = torch.as_tensor(np.asarray(node_x, np.float32), device=dev)
        n = self._node_x.shape[0]
        # Sentinel rows: src / dst = N never match a seed, time INT32_MAX
        # fails the time filter.
        pad = lambda a, fill: torch.as_tensor(
            np.concatenate([np.asarray(a, np.int32), np.full(G, fill, np.int32)]), device=dev)
        self._src = pad(src, n)
        self._dst = pad(edge_dst_full, n)
        self._t = pad(edge_time_full, _INT32_MAX)

    def apply(self, state: Any, batch: DGBatch) -> Tuple[Any, DGBatch]:
        G = self._G
        B = batch.edge_src.shape[0]
        valid = batch.edge_valid
        if valid is None:
            valid = torch.ones(B, dtype=torch.bool, device=batch.edge_src.device)
        # The window ends at the batch slice's end, unclamped past the
        # split's last event (the sentinel rows stand for the absent ones).
        end = batch.edge_ids[0].long() - self._base + B
        start = (end - G).clamp(0, self._E)
        idx = start + torch.arange(G, device=end.device)
        win_src, win_dst, win_t = self._src[idx], self._dst[idx], self._t[idx]
        min_t = torch.where(valid, batch.edge_time, _INT32_MAX).min()
        win_valid = (idx < end) & (win_t.long() <= min_t.long() - 1)

        seeds = torch.cat([getattr(batch, k) for k in self.seed_keys])
        # (S, G) occurrence masks: seed == src counts dst, and vice versa.
        m_s = ((seeds[:, None] == win_src[None, :]) & win_valid[None, :]).float()
        m_d = ((seeds[:, None] == win_dst[None, :]) & win_valid[None, :]).float()
        n = self._node_x.shape[0]
        f_dst = self._node_x[win_dst.clamp(0, n - 1).long()]
        f_src = self._node_x[win_src.clamp(0, n - 1).long()]
        # Summed in fp64 and rounded once to fp32: up to 2 * G terms a row,
        # whose fp32 sum would depend on each device's summation order.
        sum_feat = (m_s.double() @ f_dst.double() + m_d.double() @ f_src.double()).float()
        count = m_s.sum(dim=1) + m_d.sum(dim=1)
        feat = sum_feat / count.clamp_min(1.0)[:, None]
        self.add_batch_attribute(batch, "time_gap_feat", feat)
        self.add_batch_attribute(batch, "time_gap_count", count)
        return state, batch

    def __call__(self, dg: DGraph, batch: DGBatch) -> DGBatch:
        return self.apply(None, batch)[1]


__all__ = ["TimeGapNeighborMeanHook"]
