"""Segment primitives (port of ``tgm_tpu/ops/segment.py``).

Graph aggregation as gather + segment reduce: ``segment_softmax`` and
``segment_sum`` are the segment ``GraphAttentionEmbedding``'s attention,
``segment_max`` plans the TGN LastAggregator's winners, and ``coo_spmm`` is
``y[dst] += w * x[src]`` over COO edges. All take an explicit
``num_segments`` and an optional validity mask over the first axis.

The JAX conventions are kept: masked entries and ids outside
``[0, num_segments)`` go to one extra segment that is dropped;
``segment_mean`` divides by a count clamped at 1; ``segment_softmax`` clamps
masked logits to -1e30 before the exp and floors its denominator at 1e-16;
a gather at segment ids wraps negative ids and clamps the rest, as a JAX
gather does. The ops are built on ``index_add`` and ``scatter_reduce`` with
no host tensor and no host sync, so a CUDA graph can capture them. They
differentiate through autograd. The mask broadcasts over ``data``'s
trailing dimensions.
"""

from __future__ import annotations

from typing import Optional

import torch

MASKED_LOGIT = -1e30


def _trail(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``mask`` of shape (E,) viewed as (E, 1, ...) against ``like``."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


def _segment_ids(segment_ids: torch.Tensor, num_segments: int,
                 mask: Optional[torch.Tensor]) -> torch.Tensor:
    """int64 ids with masked and out-of-range entries sent to ``num_segments``."""
    ids = segment_ids.long()
    keep = (ids >= 0) & (ids < num_segments)
    if mask is not None:
        keep = keep & mask
    return torch.where(keep, ids, num_segments)


def _gather(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``x[ids]`` with JAX's gather rule: negative ids wrap once, then every
    id is clamped into ``[0, len(x))``."""
    n = x.shape[0]
    ids = ids.long()
    return x[torch.where(ids < 0, ids + n, ids).clamp(0, n - 1)]


def segment_sum(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-segment sum of ``data`` over its first axis; empty segments give 0."""
    if mask is not None:
        data = data * _trail(mask, data).to(data.dtype)
    ids = _segment_ids(segment_ids, num_segments, mask)
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    return out.index_add(0, ids, data)[:num_segments]


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
    if mask is not None:
        data = torch.where(_trail(mask, data), data, initial)
    ids = _segment_ids(segment_ids, num_segments, mask)
    out = torch.full((num_segments + 1,) + tuple(data.shape[1:]), initial,
                     dtype=data.dtype, device=data.device)
    index = ids.view(-1, *([1] * (data.dim() - 1))).expand_as(data)
    out = out.scatter_reduce(0, index, data, reduce="amax", include_self=True)
    return out[:num_segments]


def segment_mean(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-segment mean of ``data``; the count is clamped at 1, so empty segments give 0."""
    s = segment_sum(data, segment_ids, num_segments, mask)
    ones = data.new_ones(data.shape[0])
    cnt = segment_sum(ones, segment_ids, num_segments, mask)
    return s / _trail(cnt, s).clamp_min(1.0)


def segment_softmax(
    logits: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Numerically stable softmax within segments; masked entries get 0.

    Masked logits are clamped to -1e30 before the exp, so no masked entry
    overflows in the forward pass and poisons the backward with inf * 0.
    """
    if mask is not None:
        logits = torch.where(_trail(mask, logits), logits, MASKED_LOGIT)
    m = segment_max(logits, segment_ids, num_segments, mask, initial=MASKED_LOGIT)
    e = torch.exp(logits - _gather(m, segment_ids).clamp_min(MASKED_LOGIT))
    if mask is not None:
        e = torch.where(_trail(mask, e), e, 0.0)
    denom = segment_sum(e, segment_ids, num_segments, mask)
    return e / _gather(denom, segment_ids).clamp_min(1e-16)


def coo_spmm(
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    edge_weight: Optional[torch.Tensor],
    x: torch.Tensor,
    num_nodes: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``y[dst] += w * x[src]`` over COO edges; ids are clipped into [0, num_nodes)."""
    msgs = x[edge_src.long().clamp(0, num_nodes - 1)]
    if edge_weight is not None:
        msgs = msgs * edge_weight[:, None]
    return segment_sum(msgs, edge_dst.long().clamp(0, num_nodes - 1), num_nodes, mask)


__all__ = ["coo_spmm", "segment_max", "segment_mean", "segment_softmax", "segment_sum"]
