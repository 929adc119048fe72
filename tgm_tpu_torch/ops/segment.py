"""Segment primitives (port of ``tgm_tpu/ops/segment.py``).

Only ``segment_max`` is ported: the plain version of ``tgn_store_commit``
plans the TGN LastAggregator's winners with it. The other segment ops are
queued in ROADMAP.md.
"""

from __future__ import annotations

from typing import Optional

import torch


def segment_max(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    initial: float = float("-inf"),
) -> torch.Tensor:
    """Per-segment max of ``data``; empty segments and masked entries give ``initial``.

    ``initial`` takes ``data``'s dtype, so integer data stays integer. It is
    passed as a Python scalar, never a host tensor, so a CUDA graph can
    capture the call.
    """
    ids = segment_ids.long()
    if mask is not None:
        data = torch.where(mask, data, initial)
        ids = torch.where(mask, ids, num_segments)
    out = torch.full((num_segments + 1,) + tuple(data.shape[1:]), initial,
                     dtype=data.dtype, device=data.device)
    index = ids.view(-1, *([1] * (data.dim() - 1))).expand_as(data)
    out.scatter_reduce_(0, index, data, reduce="amax", include_self=True)
    return out[:num_segments]
