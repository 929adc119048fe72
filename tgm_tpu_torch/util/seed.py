"""Seeding (port of ``tgm_tpu/util/seed.py``).

``seed_everything`` seeds Python's ``random``, numpy's global generator and
torch's (every device's). The port's hooks and modules take explicit seeds
and ``torch.Generator``s, so there is no root key to fork from.
"""

from __future__ import annotations

import random
from typing import Optional

import numpy as np
import torch

_seed: Optional[int] = None


def seed_everything(seed: int) -> None:
    """Seed ``random``, numpy and torch with ``seed``."""
    global _seed
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    _seed = seed


def get_seed() -> Optional[int]:
    """The seed of the last ``seed_everything`` call, or None."""
    return _seed


__all__ = ["get_seed", "seed_everything"]
