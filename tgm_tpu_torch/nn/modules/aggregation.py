"""Link-level merge aggregators (port of ``tgm_tpu/nn/modules/aggregation.py``).

The ``Aggregator`` protocol and ``ConcatMerge``; the other merges and the
graph poolings are queued in ROADMAP.md.
"""

from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

import torch


@runtime_checkable
class Aggregator(Protocol):
    @property
    def out_channels(self) -> int: ...

    def __call__(self, *args: Any, **kwargs: Any) -> Any: ...


class ConcatMerge:
    """Concatenate src/dst embeddings."""

    def __init__(self, dim: int):
        self.dim = dim

    @property
    def out_channels(self) -> int:
        return self.dim * 2

    def __call__(self, z_src: torch.Tensor, z_dst: torch.Tensor) -> torch.Tensor:
        return torch.cat([z_src, z_dst], dim=-1)
