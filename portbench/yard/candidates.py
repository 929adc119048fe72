"""TGB candidate tables for the val and test edges, read from a traffic
file's ``protocol.candidates`` block. Each row lists the items an edge's
true destination is ranked against; the true destination is never among
them.

* ``all_other_items``: every item but the true one (tgbl-wiki's protocol:
  999 of 1,000 pages), in ascending id order.
* ``historical_random``: TGB's 20-candidate protocol (``hist_rnd``, used
  for tgbl-coin, tgbl-comment and tgbl-flight): up to ``historical``
  distinct items the source linked to before the split, drawn uniformly,
  then distinct random items to a total of ``historical + random``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

from .stream import Stream


def _all_other(s: Stream, dst: np.ndarray) -> np.ndarray:
    Q = s.num_items - 1
    j = np.arange(Q)[None, :]
    d = (dst - s.first_item)[:, None]
    return (s.first_item + j + (j >= d)).astype(np.int32)


def _historical_random(s: Stream, split: str, n_hist: int, n_rand: int,
                       rng: np.random.Generator) -> np.ndarray:
    sl = s.split(split)
    src, dst = s.src[sl].astype(np.int64), s.dst[sl].astype(np.int64)
    E, Q, N = src.shape[0], n_hist + n_rand, s.num_nodes
    # Distinct (user, item) pairs seen before the split, grouped by user.
    a = s.bounds[split][0]
    pairs = np.unique(s.src[:a].astype(np.int64) * N + s.dst[:a])
    p_user, p_item = pairs // N, pairs % N
    lo = np.searchsorted(p_user, src, side="left")
    hi = np.searchsorted(p_user, src, side="right")
    cnt = hi - lo
    # Every (edge, history item) pair with a random key; the n_hist smallest
    # keys of each edge, the true item excluded.
    e_idx = np.repeat(np.arange(E), cnt)
    within = np.arange(e_idx.shape[0]) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    items = p_item[np.repeat(lo, cnt) + within]
    keys = rng.random(items.shape[0])
    keep = items != dst[e_idx]
    e_idx, items, keys = e_idx[keep], items[keep], keys[keep]
    order = np.lexsort((keys, e_idx))
    e_idx, items = e_idx[order], items[order]
    rank = np.arange(e_idx.shape[0]) - np.searchsorted(e_idx, e_idx, side="left")
    take = rank < n_hist
    out = np.full((E, Q), -1, dtype=np.int64)
    out[e_idx[take], rank[take]] = items[take]
    n_taken = np.bincount(e_idx[take], minlength=E)
    # Random items: draw a surplus, drop the true item, repeats and the
    # historical ones, keep the first to fill each row.
    M = 4 * Q
    draws = s.first_item + rng.integers(0, s.num_items, size=(E, M))
    bad = draws == dst[:, None]
    bad |= (draws[:, :, None] == out[:, None, :]).any(axis=2)
    srt = np.sort(draws, axis=1)
    dup_sorted = np.zeros_like(srt, dtype=bool)
    dup_sorted[:, 1:] = srt[:, 1:] == srt[:, :-1]
    # A draw repeats an earlier one if an equal value occurs before it.
    first_pos = np.argsort(draws, axis=1, kind="stable")
    is_later_dup = np.zeros_like(bad)
    np.put_along_axis(is_later_dup, first_pos, dup_sorted, axis=1)
    bad |= is_later_dup
    fill_rank = np.cumsum(~bad, axis=1) - 1
    need = Q - n_taken
    sel = ~bad & (fill_rank < need[:, None])
    rows, cols = np.nonzero(sel)
    out[rows, n_taken[rows] + fill_rank[rows, cols]] = draws[rows, cols]
    if (out < 0).any():
        raise RuntimeError("historical_random: too few distinct random items drawn")
    return out.astype(np.int32)


def generate(proto: Mapping, s: Stream, seed: int) -> Dict[str, np.ndarray]:
    """The (E_split, Q) int32 candidate table of each evaluated split."""
    spec = proto["candidates"]
    rng = np.random.default_rng(seed)
    out = {}
    for split in ("val", "test"):
        if spec["kind"] == "all_other_items":
            out[split] = _all_other(s, s.dst[s.split(split)])
        elif spec["kind"] == "historical_random":
            out[split] = _historical_random(s, split, int(spec["historical"]),
                                            int(spec["random"]), rng)
        else:
            raise ValueError(f"unknown candidate protocol {spec['kind']!r}")
    return out
