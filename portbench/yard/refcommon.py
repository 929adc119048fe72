"""Plain PyTorch parts that both references share: the recency neighbours
of a seed from an event log, TGB's candidate link times, the seed list of a
batch, MRR under TGB's tie rule and Time2Vec. Imports neither JAX nor
anything of the program under test.

Recency, as the log defines it: each batch pushes its valid edges in both
directions, node by node ordered by (batch, time, position in [src -> dst
events | dst -> src events]); a node keeps its last ``B`` pushed events; a
query at time ``tau`` before batch ``j``'s push selects, among the kept
events of batches before ``j``, the last ``K`` with time ``< tau``, oldest
to newest, right-aligned, PAD / 0 / -1 elsewhere.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

PAD = -1
INT32_MAX = 2**31 - 1


@dataclass
class EventLog:
    """Every pushed event, grouped by node, ordered within a node."""

    key: torch.Tensor  # (2E,) int64 node * num_batches + batch, sorted
    nbr: torch.Tensor  # (2E,) int64
    t: torch.Tensor  # (2E,) int64
    eid: torch.Tensor  # (2E,) int64
    num_batches: int


def build_log(src: np.ndarray, dst: np.ndarray, t: np.ndarray, batch_of: np.ndarray,
              num_batches: int, device) -> EventLog:
    """The log of the undirected pushes of edges ``0 .. E - 1`` (in stream
    order), edge ``e`` pushed by batch ``batch_of[e]``."""
    E = src.shape[0]
    eid = np.arange(E, dtype=np.int64)
    node = np.concatenate([src, dst]).astype(np.int64)
    nbr = np.concatenate([dst, src]).astype(np.int64)
    tt = np.concatenate([t, t]).astype(np.int64)
    bb = np.concatenate([batch_of, batch_of]).astype(np.int64)
    # Position of the event in its batch's [src events | dst events] concat.
    first = np.searchsorted(batch_of, batch_of, side="left")
    pos_in = np.arange(E) - first
    size = np.bincount(batch_of, minlength=num_batches)[batch_of]
    pos = np.concatenate([pos_in, size + pos_in])
    order = np.lexsort((pos, tt, bb, node))
    up = lambda a: torch.as_tensor(a[order], device=device)
    return EventLog(key=up(node * num_batches + bb), nbr=up(nbr), t=up(tt),
                    eid=up(np.concatenate([eid, eid])), num_batches=num_batches)


def recency(log: EventLog, seeds: torch.Tensor, taus: torch.Tensor, batch: int, B: int,
            K: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(S, K) neighbour ids, times and edge ids of ``seeds`` queried at
    ``taus`` before batch ``batch``'s push (PAD seeds get PAD rows)."""
    dev = log.key.device
    s = seeds.long().clamp_min(0)
    end = torch.searchsorted(log.key, s * log.num_batches + batch)
    start = torch.searchsorted(log.key, s * log.num_batches)
    kept_from = torch.maximum(start, end - B)
    idx = end[:, None] - B + torch.arange(B, device=dev)[None, :]
    inside = (idx >= kept_from[:, None]) & (seeds[:, None] >= 0)
    idx = idx.clamp(0, max(log.key.shape[0] - 1, 0))
    t = log.t[idx]
    ok = inside & (t < taus.long()[:, None])
    # Newest-first rank among the selected; column K - 1 - rank.
    rank = torch.flip(torch.cumsum(torch.flip(ok.long(), [1]), 1), [1]) - 1
    take = ok & (rank < K)
    col = torch.where(take, K - 1 - rank, K)
    out = lambda v, fill: torch.full((seeds.shape[0], K + 1), fill, dtype=torch.int64,
                                     device=dev).scatter_(1, col, torch.where(take, v, fill))[:, :K]
    return out(log.nbr[idx], PAD), out(t, 0), out(log.eid[idx], -1)


def ring_state(log: EventLog, num_nodes: int, batch: int, B: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each node's kept events after the pushes of batches ``< batch``:
    (N, B) ids, times and edge ids, oldest to newest, right-aligned."""
    seeds = torch.arange(num_nodes, device=log.key.device)
    taus = torch.full((num_nodes,), 2**62, dtype=torch.int64, device=log.key.device)
    return recency(log, seeds, taus, batch, B, B)


def tgb_neg_times(gen: torch.Generator, n_slots: int, n_unique: int, t_lo: int,
                  t_hi: int) -> torch.Tensor:
    """The candidate link times of one batch: ``n_slots`` uniform draws from
    the split's seeded CPU generator, ``t_lo + r % span``; the first
    ``n_unique`` belong to the batch's distinct candidates."""
    r = torch.randint(0, INT32_MAX, (n_slots,), generator=gen, dtype=torch.int64)
    return t_lo + r[:n_unique] % max(t_hi - t_lo + 1, 1)


def mrr_sum(pos: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """Sum over rows of 1 / rank, rank = 0.5 (#neg > pos + #neg >= pos) + 1,
    in float64."""
    gt = (neg > pos[:, None]).sum(1)
    ge = (neg >= pos[:, None]).sum(1)
    return (1.0 / (0.5 * (gt + ge).double() + 1.0)).sum()


def time2vec(w: torch.Tensor, b: torch.Tensor, dt: torch.Tensor) -> torch.Tensor:
    """cos(dt * w + b) with the phase rounded once (a fused multiply-add): at
    gaps of millions of seconds one ulp of the phase is a quarter radian, so
    where the phase rounds is part of the definition."""
    return torch.cos(torch.addcmul(b, dt.float()[..., None], w))


def batches_of(n_edges: int, batch_size: int) -> List[Tuple[int, int]]:
    """[start, end) of each batch of a split."""
    return [(a, min(a + batch_size, n_edges)) for a in range(0, n_edges, batch_size)]
