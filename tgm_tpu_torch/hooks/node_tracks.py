"""Node appearance tracking (port of ``tgm_tpu/hooks/node_tracks.py``).

``EdgeEventsSeenNodesTrackHook`` keeps an (N+1,) bool state of the nodes
seen in edge events (row N is the dump row, never set) and, per batch,
flags the node-label nodes already seen. The batch's own valid edges are
added before the labels are checked, as in JAX, so a label node that is an
endpoint in the same batch counts as seen.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ..constants import PADDED_NODE_ID
from ..core.batch import DGBatch
from ..core.graph import DGraph
from ..device import DeviceLike, resolve_device
from .base import StatefulHook
from .registry import hook


@hook
class EdgeEventsSeenNodesTrackHook(StatefulHook):
    """Produce, per batch, the node-label nodes already seen in edge events:
    ``batch_nodes_mask`` (L,) bool over ``node_y_nids`` and ``seen_nodes``
    (L,) with the seen ids and PAD elsewhere (both empty without labels)."""

    _cls_requires = {"edge_src", "edge_dst"}
    _cls_produces = {"seen_nodes", "batch_nodes_mask"}

    def __init__(self, num_nodes: int, device: DeviceLike = None,
                 id: Optional[str] = None) -> None:
        super().__init__(id=id)
        if num_nodes < 0:
            raise ValueError("num_nodes must be non-negative")
        self._num_nodes = num_nodes
        self.device = resolve_device(device)

    def init_state(self, dg: Optional[DGraph] = None) -> Any:
        return torch.zeros((self._num_nodes + 1,), dtype=torch.bool, device=self.device)

    def apply(self, state: Any, batch: DGBatch) -> Tuple[Any, DGBatch]:
        seen = state
        n = self._num_nodes

        def rows(ids, valid):
            ok = (ids >= 0) & (ids < n)
            if valid is not None:
                ok = ok & valid
            return torch.where(ok, ids, n).long()

        seen[rows(batch.edge_src, batch.edge_valid)] = True
        seen[rows(batch.edge_dst, batch.edge_valid)] = True
        seen[n] = False

        if batch.has("node_y_nids"):
            ids = batch.node_y_nids
            ok = (ids >= 0) & (ids < n)
            if batch.has("node_y_valid"):
                ok = ok & batch.node_y_valid
            previously_seen = seen[torch.where(ok, ids, n).long()] & ok
            seen_nodes = torch.where(previously_seen, ids, PADDED_NODE_ID)
        else:
            dev = batch.edge_src.device
            previously_seen = torch.zeros((0,), dtype=torch.bool, device=dev)
            seen_nodes = torch.zeros((0,), dtype=torch.int32, device=dev)

        self.add_batch_attribute(batch, "batch_nodes_mask", previously_seen)
        self.add_batch_attribute(batch, "seen_nodes", seen_nodes)
        return seen, batch
