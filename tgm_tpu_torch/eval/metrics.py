"""TGB link-prediction metrics (port of ``tgm_tpu/eval/metrics.py``).

MRR with TGB's tie handling: the rank of the positive among its candidates is
the mean of the optimistic (#neg > pos) and pessimistic (#neg >= pos) ranks.
Mask-aware: padded candidates and padded batch rows are excluded. NDCG and
the other metrics are queued in ROADMAP.md.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def mrr_per_edge(
    pos_score: torch.Tensor,
    neg_scores: torch.Tensor,
    neg_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B,) reciprocal ranks: rank = 0.5 * (#neg > pos) + 0.5 * (#neg >= pos) + 1."""
    pos = pos_score[:, None]
    gt = neg_scores > pos
    ge = neg_scores >= pos
    if neg_valid is not None:
        gt, ge = gt & neg_valid, ge & neg_valid
    rank = 0.5 * (gt.sum(dim=1) + ge.sum(dim=1)).to(pos_score.dtype) + 1.0
    return 1.0 / rank


def mrr(
    pos_score: torch.Tensor,
    neg_scores: torch.Tensor,
    neg_valid: Optional[torch.Tensor] = None,
    edge_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean reciprocal rank over the valid edges of a batch. Without
    ``edge_valid`` it is the plain mean, nan for an empty batch (as
    ``jnp.mean``); with it, 0 when no edge is valid."""
    if edge_valid is None:
        return mrr_per_edge(pos_score, neg_scores, neg_valid).mean()
    s, c = mrr_sum_count(pos_score, neg_scores, neg_valid, edge_valid)
    return s / torch.clamp_min(c, 1.0)


def mrr_sum_count(
    pos_score: torch.Tensor,
    neg_scores: torch.Tensor,
    neg_valid: Optional[torch.Tensor] = None,
    edge_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of reciprocal ranks, count): accumulate across batches, then divide."""
    rr = mrr_per_edge(pos_score, neg_scores, neg_valid)
    if edge_valid is None:
        return rr.sum(), torch.tensor(float(rr.shape[0]), dtype=rr.dtype, device=rr.device)
    w = edge_valid.to(rr.dtype)
    return (rr * w).sum(), w.sum()
