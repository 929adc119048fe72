"""The order in which the plain references walk the stream: the train
split folded, then val and test batch by batch, as the window serves them
(plain Python, no program imports)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from .refcommon import batches_of


@dataclass
class Plan:
    samples: Set[Tuple[str, int]]  # batches whose scores and hook products the window keeps
    scored: Set[Tuple[str, int]]  # batches whose scores and MRR the reference works out
    end: Optional[Tuple[str, int]]  # the last batch served before the window closed
    keep_rows: int  # hook-product rows kept per sampled batch
    capture_rows: Optional[int] = None  # pair rows of the program's row-limited captures


def sample_keys(seed: int, n_val: int, n_test: int, k: int):
    """``k`` val / test batches drawn from the seed (val batch 1 always)."""
    from .seeds import derive

    keys = [("val", i) for i in range(n_val)] + [("test", i) for i in range(n_test)]
    rng = np.random.default_rng(derive(seed, "sample"))
    pick = rng.permutation(len(keys))[:max(k - 1, 0)]
    return {("val", min(1, n_val - 1))} | {keys[i] for i in pick}


@dataclass
class Batch:
    split: str
    index: int  # within the split
    gidx: int  # across the stream
    lo: int  # first edge (stream order)
    hi: int  # end edge
    row0: int  # first candidate row of the split's table


def walk(bounds: Dict[str, Tuple[int, int]], batch_size: int) -> Tuple[List[Batch], np.ndarray]:
    """Every batch of train, val and test in order, and each edge's batch."""
    out, batch_of = [], np.zeros(bounds["test"][1], dtype=np.int64)
    g = 0
    for split in ("train", "val", "test"):
        a, b = bounds[split]
        for i, (lo, hi) in enumerate(batches_of(b - a, batch_size)):
            out.append(Batch(split, i, g, a + lo, a + hi, lo))
            batch_of[a + lo:a + hi] = g
            g += 1
    return out, batch_of
