"""Example datasets (port of ``examples/_datasets.py``).

A TGB name loads through ``DGData.from_tgb`` (the optional ``py-tgb``
package), with no candidate arrays: the TGB hooks then load the package's.
``synthetic[-N-E]`` generates a reproducible interaction stream shaped like
tgbl-wiki (default N = 1,000 nodes, E = 20,000 events, 172-dim edge
features) with power-law node activity, a TGB-style 70/15/15 split over
time and pre-generated negative candidates for val and test;
``node_label_classes > 0`` adds tgbn-style node-label events.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..data import DGData
from ..data.split import TGBSplit


def load_dataset(
    name: str, num_negatives: int = 20, edge_dim: int = 172, seed: int = 0,
    node_label_classes: int = 0,
) -> Tuple[DGData, Optional[np.ndarray], Optional[np.ndarray]]:
    """Return (data, val_candidates, test_candidates).

    ``node_label_classes > 0`` attaches node-label events: the source of
    every 20th edge is labelled, at that edge's time, with the class mix
    (classes = dst % C) of the next 5 edges' destinations. It draws no
    random numbers, so the edges and candidates stay as they are.
    """
    if not name.startswith("synthetic"):
        return DGData.from_tgb(name), None, None
    parts = name.split("-")
    n_nodes = int(parts[1]) if len(parts) > 1 else 1000
    n_events = int(parts[2]) if len(parts) > 2 else 20000

    rng = np.random.default_rng(seed)
    # Power-lawish activity: a few hot nodes, many cold ones (wiki-like).
    popularity = rng.zipf(1.5, size=n_nodes).astype(np.float64)
    popularity /= popularity.sum()
    src = rng.choice(n_nodes, size=n_events, p=popularity)
    dst = rng.choice(n_nodes, size=n_events, p=popularity)
    dst = np.where(dst == src, (dst + 1) % n_nodes, dst)
    t = np.sort(rng.integers(0, n_events * 4, size=n_events))
    edge_x = rng.normal(size=(n_events, edge_dim)).astype(np.float32)

    labels = {}
    if node_label_classes > 0:
        C = node_label_classes
        cls = dst % C
        label_idx = np.arange(0, n_events - 6, 20)
        y = np.zeros((len(label_idx), C), dtype=np.float32)
        for row, i in enumerate(label_idx):
            np.add.at(y[row], cls[i : i + 5], 1.0)
        y /= np.maximum(y.sum(1, keepdims=True), 1)
        labels = dict(node_y_time=t[label_idx], node_y_nids=src[label_idx].astype(np.int32),
                      node_y=y)

    data = DGData.from_raw(edge_time=t, edge_index=np.stack([src, dst], 1).astype(np.int32),
                           edge_x=edge_x, time_delta="s", **labels)
    # 70/15/15 TGB-style split bounds over time.
    t_lo, t_hi = int(t.min()), int(t.max())
    span = t_hi - t_lo + 1
    val_t = t_lo + int(span * 0.70)
    test_t = t_lo + int(span * 0.85)
    data._split_strategy = TGBSplit(
        {"train": (t_lo, val_t - 1), "val": (val_t, test_t - 1), "test": (test_t, t_hi)}
    )

    def candidates(lo: int, hi: int) -> np.ndarray:
        n = int(((t >= lo) & (t <= hi)).sum())
        return rng.choice(n_nodes, size=(n, num_negatives), p=popularity)

    return data, candidates(val_t, test_t - 1), candidates(test_t, t_hi)
