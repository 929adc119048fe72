"""Embedding merge and pooling aggregators (port of ``tgm_tpu/nn/modules/aggregation.py``).

The ``Aggregator`` protocol; ``ConcatMerge`` and ``LearnableSumMerge``
(link-level merges of src and dst embeddings); ``MeanEmbdPooling`` and
``SumEmbdPooling`` (graph-level pooling, mask-aware because batches are
padded).
"""

from __future__ import annotations

from typing import Any, Optional, Protocol, runtime_checkable

import torch
from torch import nn


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


class LearnableSumMerge(nn.Module):
    """Sum after per-side linear projections. The flax module's ``Dense_0``
    and ``Dense_1`` are ``src`` and ``dst`` here (``weights.load_learnable_sum_merge``)."""

    def __init__(self, dim: int, in_dim: Optional[int] = None):
        super().__init__()
        self.dim = dim
        in_dim = dim if in_dim is None else in_dim
        self.src = nn.Linear(in_dim, dim)
        self.dst = nn.Linear(in_dim, dim)

    @property
    def out_channels(self) -> int:
        return self.dim

    def forward(self, z_src: torch.Tensor, z_dst: torch.Tensor) -> torch.Tensor:
        return self.src(z_src) + self.dst(z_dst)


class MeanEmbdPooling:
    """Mean over the rows of ``z``; with ``valid``, over the valid rows
    (0 when none is)."""

    def __init__(self, dim: int):
        self.dim = dim

    @property
    def out_channels(self) -> int:
        return self.dim

    def __call__(self, z: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        if valid is None:
            return z.mean(dim=0)
        w = valid.to(z.dtype)[:, None]
        return (z * w).sum(dim=0) / w.sum().clamp_min(1.0)


class SumEmbdPooling:
    """Sum over the (valid) rows of ``z``."""

    def __init__(self, dim: int):
        self.dim = dim

    @property
    def out_channels(self) -> int:
        return self.dim

    def __call__(self, z: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        if valid is None:
            return z.sum(dim=0)
        return (z * valid.to(z.dtype)[:, None]).sum(dim=0)
