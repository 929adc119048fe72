"""Device-resident event streams (port of ``tgm_tpu/train/stream.py``).

``DeviceEdgeStream`` uploads a split's edge events to the device once and
serves fixed-width batch windows with global ``edge_ids``: the split's rows
offset by its place in the pre-split dataset (``DGData.edge_global_offset``),
so one full-dataset feature table serves every split.

``DeviceEventStream`` serves a ``DGDataLoader``'s batch plan (edge,
node-feature and node-label windows, event- or time-ordered) from arrays
uploaded once. The plan's offsets and counts stay on the host, so
``batch_at(i)`` only issues slices and masks and never waits for the card;
it keeps empty batches, as the JAX stream's scan does.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..constants import PADDED_NODE_ID
from ..core.batch import DGBatch
from ..core.graph import DGraph, pad_rows
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


class DeviceEventStream:
    """A ``DGDataLoader``'s batch plan served from arrays on the loader's device.

    ``batch_at(i)`` gives what the loader's ``materialize`` gives for batch
    ``i`` at the plan's widths (``edge_ids``, ``edge_type``, and with the
    loader's ``materialize_features`` ``edge_x`` and the node-feature and
    label fields), plus ``num_node_labels``, the batch's label count from
    the plan (a host int). Batches the loader skips as empty are kept.
    """

    def __init__(self, loader):
        self.device = loader.device
        plan = loader.plan()
        data = loader.dgraph._storage._data
        self.num_batches = len(plan)
        self._plan = plan
        # ``x`` on the device followed by ``w`` rows of ``fill``: every window
        # of width ``w`` that starts at a row of ``x`` stays in bounds.
        up = lambda x, w, fill: torch.as_tensor(pad_rows(x, len(x) + w, fill)[0],
                                                device=self.device)

        W = self._We = plan.pad_edges
        E = data.num_edge_events
        self._src = up(data.edge_index[:, 0].astype(np.int32), W, PADDED_NODE_ID)
        self._dst = up(data.edge_index[:, 1].astype(np.int32), W, PADDED_NODE_ID)
        self._t = up(data.edge_time.astype(np.int32), W, 0)
        ids = data.edge_global_offset + np.arange(E, dtype=np.int32)
        self._ids = up(ids.astype(np.int32), W, -1)
        feats = loader.materialize_features
        self._edge_x = None if data.edge_x is None or not feats else up(data.edge_x, W, 0.0)
        self._edge_type = (None if data.edge_type is None
                           else up(data.edge_type.astype(np.int32), W, 0))
        self._e_off = plan.edge_offsets.tolist()
        self._e_cnt = plan.edge_counts.tolist()
        self._ar_e = torch.arange(W, device=self.device)

        def node_windows(prefix: str):
            """The plan's windows over one kind of node events, or None."""
            offsets = getattr(plan, f"{prefix}_offsets")
            nids = getattr(data, f"{prefix}_nids")
            if not feats or offsets is None or nids is None:
                return None
            Wn, x = getattr(plan, f"pad_{prefix}"), getattr(data, prefix)
            return {
                "W": Wn,
                "nids": up(nids.astype(np.int32), Wn, PADDED_NODE_ID),
                "t": up(getattr(data, f"{prefix}_time").astype(np.int32), Wn, 0),
                "x": None if x is None else up(x, Wn, 0.0),
                "off": offsets.tolist(),
                "cnt": getattr(plan, f"{prefix}_counts").tolist(),
                "ar": torch.arange(Wn, device=self.device),
            }

        self._nx = node_windows("node_x")
        self._ny = node_windows("node_y")

    @property
    def edge_x(self) -> Optional[torch.Tensor]:
        """The data's edge feature table on the device (padded rows zero)."""
        return self._edge_x

    def batch_at(self, i: int) -> DGBatch:
        """Batch ``i``: the plan's windows, rows past each count masked."""
        if not 0 <= i < self.num_batches:
            raise IndexError(f"batch {i} out of range [0, {self.num_batches})")
        W, s = self._We, self._e_off[i]
        valid = self._ar_e < self._e_cnt[i]
        win = lambda a: a[s : s + W]
        batch = DGBatch(
            torch.where(valid, win(self._src), PADDED_NODE_ID),
            torch.where(valid, win(self._dst), PADDED_NODE_ID),
            torch.where(valid, win(self._t), 0),
            valid,
            edge_ids=torch.where(valid, win(self._ids), -1),
        )
        if self._edge_x is not None:
            batch.edge_x = torch.where(valid[:, None], win(self._edge_x), 0.0)
        if self._edge_type is not None:
            batch.edge_type = torch.where(valid, win(self._edge_type), 0)
        for prefix, w in (("node_x", self._nx), ("node_y", self._ny)):
            if w is None:
                continue
            s, Wn = w["off"][i], w["W"]
            v = w["ar"] < w["cnt"][i]
            wn = lambda a: a[s : s + Wn]
            setattr(batch, f"{prefix}_time", torch.where(v, wn(w["t"]), 0))
            setattr(batch, f"{prefix}_nids", torch.where(v, wn(w["nids"]), PADDED_NODE_ID))
            if w["x"] is not None:
                setattr(batch, prefix, torch.where(v[:, None], wn(w["x"]), 0.0))
            setattr(batch, f"{prefix}_valid", v)
        if self._ny is not None:
            batch.num_node_labels = self._ny["cnt"][i]
        return batch
