"""The general generator of a bipartite interaction stream, read from a
traffic file's ``stream`` block.

Users link to items (users are the sources, ids ``0 .. users - 1``; items
the destinations, ids ``users .. users + items - 1``). Each event picks its
user by a heavy-tailed activity weight; with probability ``repeat_prob``
it repeats the item of one of that user's earlier events, drawn uniformly,
else it draws an item by a heavy-tailed popularity weight. Times are
``edges`` distinct whole seconds over ``[0, time_span_s]``, so a
chronological split by edge counts is exact. Edge features are N(0, 1).
Everything is drawn in bulk from one numpy generator seeded from ``seed``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping

import numpy as np


@dataclass
class Stream:
    """A generated stream, sorted by time, with its chronological split."""

    src: np.ndarray  # (E,) int32
    dst: np.ndarray  # (E,) int32
    t: np.ndarray  # (E,) int64, strictly increasing
    edge_x: np.ndarray  # (E, D) float32
    num_nodes: int
    first_item: int
    num_items: int
    bounds: Dict[str, tuple]  # split -> (first edge, end edge)

    def split(self, name: str) -> slice:
        a, b = self.bounds[name]
        return slice(a, b)


def _weights(rng: np.random.Generator, n: int, law: Mapping) -> np.ndarray:
    if law["law"] != "lognormal":
        raise ValueError(f"unknown activity law {law['law']!r}")
    w = rng.lognormal(0.0, float(law["sigma"]), size=n)
    return w / w.sum()


def _repeat_roots(user: np.ndarray, repeat: np.ndarray, u01: np.ndarray) -> np.ndarray:
    """For each event, the event whose fresh item it carries: itself, or for
    a repeat, the root of a uniformly drawn earlier event of the same user
    (pointer jumping over the chains of repeats)."""
    E = user.shape[0]
    order = np.argsort(user, kind="stable")  # by user, then time
    u_sorted = user[order]
    starts = np.searchsorted(u_sorted, u_sorted, side="left")
    k = np.arange(E) - starts  # index among the user's events
    parent_sorted = np.arange(E)
    rep = repeat[order] & (k > 0)
    pick = starts + np.floor(u01[order] * k).astype(np.int64)
    parent_sorted = np.where(rep, pick, parent_sorted)
    parent = np.empty(E, dtype=np.int64)
    parent[order] = order[parent_sorted]
    for _ in range(64):
        nxt = parent[parent]
        if np.array_equal(nxt, parent):
            return parent
        parent = nxt
    raise RuntimeError("repeat chains did not converge")


def generate(p: Mapping, seed: int) -> Stream:
    users, items, E = int(p["users"]), int(p["items"]), int(p["edges"])
    span, D = int(p["time_span_s"]), int(p["edge_dim"])
    rng = np.random.default_rng(seed)
    w_user = _weights(rng, users, p["user_activity"])
    w_item = _weights(rng, items, p["item_popularity"])
    user = rng.choice(users, size=E, p=w_user)
    fresh = rng.choice(items, size=E, p=w_item)
    repeat = rng.random(E) < float(p["repeat_prob"])
    roots = _repeat_roots(user, repeat, rng.random(E))
    item = fresh[roots]
    t = np.sort(rng.choice(span + 1, size=E, replace=False)).astype(np.int64)
    edge_x = rng.standard_normal((E, D), dtype=np.float32)
    cuts = np.cumsum([0] + [int(round(f * E)) for f in p["split"][:-1]] + [0])
    cuts[-1] = E
    bounds = {name: (int(cuts[i]), int(cuts[i + 1]))
              for i, name in enumerate(("train", "val", "test"))}
    return Stream(src=user.astype(np.int32), dst=(users + item).astype(np.int32), t=t,
                  edge_x=edge_x, num_nodes=users + items, first_item=users, num_items=items,
                  bounds=bounds)


def repeat_share(s: Stream, split: str) -> float:
    """Share of the split's edges whose (user, item) pair occurred earlier."""
    key = s.src.astype(np.int64) * s.num_nodes + s.dst
    sl = s.split(split)
    seen = np.zeros(key.shape[0], dtype=bool)
    order = np.argsort(key, kind="stable")
    ks = key[order]
    first = np.ones_like(ks, dtype=bool)
    first[1:] = ks[1:] != ks[:-1]
    seen[order] = ~first
    return float(seen[sl].mean())
