"""Dense id lookups of the serving path (port of ``tgm_tpu/hooks/dedup.py``).

``map_to_local``, ``seed_lookup`` and ``candidate_rows``. The
``DeduplicationHook`` itself is queued in ROADMAP.md (the rowwise eval path
does not need it).
"""

from __future__ import annotations

from typing import Tuple

import torch


def map_to_local(g2l: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Map global ids through a dense (num_nodes + 1,) table (PAD-safe)."""
    n = g2l.shape[0] - 1
    return g2l[torch.where((ids >= 0) & (ids < n), ids, n).long()]


def seed_lookup(seeds: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """Dense id -> row table for a seed list; the LAST occurrence wins.

    The TGB hook's unique-candidate section trails the seed list, so each
    candidate's last occurrence is its own row. Unknown ids map to -1.
    """
    S = seeds.shape[0]
    lut = torch.full((num_nodes + 1,), -1, dtype=torch.int32, device=seeds.device)
    rows = torch.where((seeds >= 0) & (seeds < num_nodes), seeds, num_nodes).long()
    pos = torch.arange(S, dtype=torch.int32, device=seeds.device)
    lut.scatter_reduce_(0, rows, pos, reduce="amax", include_self=True)
    lut[num_nodes] = -1
    return lut


def candidate_rows(
    lut: torch.Tensor, cands: torch.Tensor, num_rows: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map candidate ids through a :func:`seed_lookup` table.

    Returns ``(rows, found)``: row indices clipped into [0, num_rows) and a
    mask of the candidates present in the seed list. AND ``found`` into the
    scoring mask, or a missing candidate scores against row 0.
    """
    n = lut.shape[0] - 1
    raw = lut[torch.where((cands >= 0) & (cands < n), cands, n).long()]
    return raw.clamp(0, num_rows - 1), raw >= 0
