"""Device placement hooks (port of ``tgm_tpu/hooks/device.py``).

The port's loaders and streams build their batches on the device already;
these hooks serve a batch built elsewhere. ``PinMemoryHook`` pins the
batch's CPU tensors (page-locked host memory, so a later copy to the card
can run asynchronously) where a card is present, and passes the batch
through otherwise; ``DeviceTransferHook`` copies every tensor of the batch
to an explicit device with ``non_blocking=True`` (``device=None`` passes the
batch through, as in JAX).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from ..core.batch import DGBatch
from ..core.graph import DGraph
from ..device import DeviceLike, resolve_device
from .base import StatelessHook
from .registry import hook


def _map_tensors(batch: DGBatch, fn: Callable[[torch.Tensor], torch.Tensor]) -> DGBatch:
    """A new batch with ``fn`` applied to every tensor, in lists and tuples too."""

    def move(v: Any) -> Any:
        if isinstance(v, torch.Tensor):
            return fn(v)
        if isinstance(v, (list, tuple)):
            return type(v)(move(x) for x in v)
        if isinstance(v, dict):
            return {k: move(x) for k, x in v.items()}
        return v

    out = DGBatch.__new__(DGBatch)
    out.__dict__.update({k: move(v) for k, v in batch.__dict__.items()})
    return out


@hook
class PinMemoryHook(StatelessHook):
    """Pin the batch's CPU tensors where a card is present; else pass through."""

    _cls_requires: set = set()
    _cls_produces: set = set()

    def apply(self, state: Any, batch: DGBatch) -> Tuple[Any, DGBatch]:
        if not torch.cuda.is_available():
            return state, batch
        return state, _map_tensors(batch, lambda t: t.pin_memory() if t.device.type == "cpu"
                                   else t)

    def __call__(self, dg: DGraph, batch: DGBatch) -> DGBatch:
        return self.apply(None, batch)[1]


@hook
class DeviceTransferHook(StatelessHook):
    """Copy every tensor of the batch to ``device`` (``None``: leave it)."""

    _cls_requires: set = set()
    _cls_produces: set = set()

    def __init__(self, device: DeviceLike = None, id: Optional[str] = None) -> None:
        super().__init__(id=id)
        self.device = None if device is None else resolve_device(device)

    def apply(self, state: Any, batch: DGBatch) -> Tuple[Any, DGBatch]:
        if self.device is None:
            return state, batch
        return state, _map_tensors(batch, lambda t: t.to(self.device, non_blocking=True))

    def __call__(self, dg: DGraph, batch: DGBatch) -> DGBatch:
        return self.apply(None, batch)[1]
