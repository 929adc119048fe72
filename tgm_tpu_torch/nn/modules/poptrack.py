"""PopTrack, the destination-popularity baseline (port of
``tgm_tpu/nn/modules/poptrack.py``).

Popularity is an fp64 ``(num_nodes,)`` tensor on the device. An update
adds 1.0 per edge at its destination (``index_add_``), then multiplies by
``decay``. All the addends are equal, so the adds give numpy's
``np.add.at`` result bit for bit in any order; adding per-node counts at
once would not, as ``p + n`` rounds differently from n steps of ``+ 1.0``
once ``p`` is fractional. A padding row (a negative id) adds 0.0 instead.
A query scores ``popularity[dst]`` as float32, whatever the source; a
negative id reads from the end, as numpy's does, and an id past the table
(a TGB candidate no edge touches) scores 0, where numpy raises.
"""

from __future__ import annotations

import torch

from ...device import DeviceLike, resolve_device
from .edgebank import as_long, check_edges, valid_edges


class PopTrackPredictor:
    def __init__(
        self,
        src,
        dst,
        ts,
        num_nodes: int,
        k: int = 50,
        decay: float = 0.9,
        device: DeviceLike = None,
    ) -> None:
        if k <= 0:
            raise ValueError("K must be positive")
        if decay <= 0 or decay > 1:
            raise ValueError("Decay must be in (0,1]")
        if num_nodes <= 0:
            raise ValueError("num_nodes must be set to the total number of nodes")
        if k > num_nodes:
            raise ValueError("k must be smaller than num_nodes")
        self.device = resolve_device(device)
        self.popularity = torch.zeros(num_nodes, dtype=torch.float64, device=self.device)
        self.k = k
        self.decay = decay
        self.update(src, dst, ts)

    def update(self, src, dst, ts) -> None:
        src, dst, ts = (as_long(x, self.device) for x in (src, dst, ts))
        check_edges(src, dst, ts)
        valid = valid_edges(src, dst)
        self.popularity.index_add_(0, torch.where(valid, dst, 0), valid.double())
        self.popularity.mul_(self.decay)

    def __call__(self, query_src, query_dst) -> torch.Tensor:
        q = as_long(query_dst, self.device)
        N = self.popularity.numel()
        return torch.where(q < N, self.popularity[q.clamp(-N, N - 1)], 0.0).float()


__all__ = ["PopTrackPredictor"]
