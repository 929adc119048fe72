"""TGB metrics (port of ``tgm_tpu/eval/metrics.py``).

MRR with TGB's tie handling: the rank of the positive among its candidates is
the mean of the optimistic (#neg > pos) and pessimistic (#neg >= pos) ranks;
NDCG@k for node property prediction; ``binary_accuracy`` of link logits
and ``mse`` of graph-level regression. Mask-aware: padded candidates and
padded batch rows are excluded.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..constants import DEFAULT_NDCG_K


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


def ndcg_at_k(
    scores: torch.Tensor,
    labels: torch.Tensor,
    k: int = DEFAULT_NDCG_K,
    row_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """NDCG@k of (B, C) scores against (B, C) non-negative relevances, the
    mean over the valid rows (at least 1); a row whose labels are all zero
    scores 0. Ties between scores keep the lower class first (a stable
    sort, as ``jnp.argsort``): they decide which gains are counted. The
    discounts are fp32."""
    k = min(k, scores.shape[-1])
    discounts = 1.0 / torch.log2(torch.arange(k, dtype=torch.float32, device=scores.device) + 2.0)
    order = torch.argsort(-scores, dim=-1, stable=True)[:, :k]
    dcg = (torch.gather(labels, -1, order) * discounts).sum(-1)
    ideal = torch.sort(labels, dim=-1, descending=True).values[:, :k]
    idcg = (ideal * discounts).sum(-1)
    ndcg = torch.where(idcg > 0, dcg / idcg.clamp_min(1e-12), 0.0)
    if row_valid is None:
        return ndcg.mean()
    w = row_valid.to(ndcg.dtype)
    return (ndcg * w).sum() / w.sum().clamp_min(1.0)


def binary_accuracy(
    pos_score: torch.Tensor,
    neg_score: torch.Tensor,
    threshold: float = 0.0,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Share of positives above ``threshold`` and negatives at or below it;
    with ``valid``, over the valid rows of both (the pair count at least 1)."""
    if valid is None:
        correct = ((pos_score > threshold).float().sum()
                   + (neg_score <= threshold).float().sum())
        total = pos_score.numel() + neg_score.numel()
        return correct / max(total, 1)
    correct = (((pos_score > threshold) & valid).sum()
               + ((neg_score <= threshold) & valid).sum())
    return correct / (2 * valid.sum()).clamp_min(1)


def mse(pred: torch.Tensor, target: torch.Tensor,
        valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean squared error; with ``valid``, over the valid rows, a mask of
    fewer dimensions than the error broadcasting over its trailing ones
    (the count at least 1)."""
    err = (pred - target) ** 2
    if valid is None:
        return err.mean()
    w = valid.to(err.dtype)
    while w.dim() < err.dim():
        w = w[..., None]
    return (err * w).sum() / (w.sum() * (err.numel() / w.numel())).clamp_min(1.0)
