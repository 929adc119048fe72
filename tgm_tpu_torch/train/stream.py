"""Device-resident edge stream (port of ``tgm_tpu/train/stream.py::DeviceEdgeStream``).

Uploads a split's edge events to the device once and serves fixed-width
batch windows with global ``edge_ids``: the split's rows offset by its place
in the pre-split dataset (``DGData.edge_global_offset``), so one full-dataset
feature table serves every split. ``DeviceEventStream`` (node events and
labels) is queued in ROADMAP.md.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..constants import PADDED_NODE_ID
from ..core.batch import DGBatch
from ..core.graph import DGraph
from ..device import DeviceLike, resolve_device


class DeviceEdgeStream:
    """A DGraph's edge events on ``device``, served as batch windows."""

    def __init__(self, dg: DGraph, batch_size: int, device: DeviceLike = None):
        self.device = resolve_device(device)
        edge_id_base = int(dg._storage._data.edge_global_offset)
        src, dst, t = dg._storage.get_edges(dg._slice)
        E = len(src)
        self.num_edges = E
        self.batch_size = batch_size
        self.num_batches = max(1, math.ceil(E / batch_size))

        total = self.num_batches * batch_size
        pad = total - E
        up = lambda x: torch.as_tensor(x, device=self.device)
        padi = lambda x, fill: np.concatenate([x.astype(np.int32), np.full(pad, fill, np.int32)])
        self._src = up(padi(src, PADDED_NODE_ID))
        self._dst = up(padi(dst, PADDED_NODE_ID))
        self._t = up(padi(t, 0))
        self._valid = up(np.arange(total) < E)
        ids = np.where(np.arange(total) < E, edge_id_base + np.arange(total), -1)
        self._edge_ids = up(ids.astype(np.int32))

        self._edge_x: Optional[torch.Tensor] = None
        ex = dg._storage.get_edge_x(dg._slice)
        if ex is not None:
            self._edge_x = up(np.concatenate([ex, np.zeros((pad, ex.shape[1]), ex.dtype)]))

    @property
    def edge_x(self) -> Optional[torch.Tensor]:
        """The split's edge feature table on the device (padded rows zero)."""
        return self._edge_x

    def batch_at(self, i: int) -> DGBatch:
        """Batch ``i``: views of the uploaded arrays (padded rows hold PAD / 0 / -1)."""
        if not 0 <= i < self.num_batches:
            raise IndexError(f"batch {i} out of range [0, {self.num_batches})")
        sl = slice(i * self.batch_size, (i + 1) * self.batch_size)
        batch = DGBatch(self._src[sl], self._dst[sl], self._t[sl], self._valid[sl],
                        edge_ids=self._edge_ids[sl])
        if self._edge_x is not None:
            batch.edge_x = self._edge_x[sl]
        return batch
