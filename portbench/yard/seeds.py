"""Seeds of the run's parts, derived from ``--seed`` (any non-negative int)."""

from __future__ import annotations

import numpy as np

_TAGS = ("stream", "candidates", "weights", "val_times", "test_times", "train_times",
         "sample")


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for ``tag``, a fixed function of ``seed``."""
    ss = np.random.SeedSequence(entropy=int(seed), spawn_key=(_TAGS.index(tag),))
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))
