"""Slice tracker of the storage engine (port of ``tgm_tpu/core/_storage/base.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class DGSliceTracker:
    """A temporal and/or event-index slice of a dynamic graph.

    Time bounds are inclusive on both ends; index bounds clamp the global
    event-timeline range ``[start_idx, end_idx)``.
    """

    start_time: Optional[int] = None
    end_time: Optional[int] = None
    start_idx: Optional[int] = None
    end_idx: Optional[int] = None
