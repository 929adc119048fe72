"""Node-id deduplication (port of ``tgm_tpu/hooks/dedup.py``).

``DeduplicationHook`` collects a batch's node ids (edge endpoints, the seed
keys, every hop of ``nbr_nids``) into sorted ``unique_nids`` with a dense
global -> local table; ``map_to_local``, ``seed_lookup`` and
``candidate_rows`` are the dense id lookups the cores use.

Static shapes throughout, as in the JAX package: ``unique_nids`` has a fixed
capacity ``U = min(total ids, num_nodes + 1)`` and is PAD-filled at the tail;
``global_to_local`` is a dense (num_nodes + 1,) table, -1 for unseen ids and
for the PAD slot. The unique is a sort, a first-of-run mask, a ``cumsum`` and
a scatter into a sentinel-filled buffer: it never asks the card for the
count (``torch.unique`` would), so nothing waits for the card.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch

from ..constants import PADDED_NODE_ID
from ..core.batch import DGBatch
from ..core.graph import DGraph
from .base import SeedableHook, StatelessHook
from .registry import hook

SENTINEL = torch.iinfo(torch.int32).max


def sorted_unique(ids: torch.Tensor, num_nodes: int, size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jnp.unique(keyed, size=size, fill_value=SENTINEL)`` of the ids in
    ``[0, num_nodes)``, every other id keyed to ``SENTINEL``.

    Returns ``(uniq, valid)``: the (size,) int32 sorted distinct ids, the
    sentinel after them, and the mask of the real ones. Distinct values past
    ``size`` are dropped, as the JAX function drops them.
    """
    keyed = torch.where((ids >= 0) & (ids < num_nodes), ids, SENTINEL).to(torch.int32)
    s, _ = torch.sort(keyed)
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    pos = torch.cumsum(first, 0) - 1  # each value's slot in the unique list
    slot = torch.where(first & (pos < size), pos, size)
    uniq = torch.full((size + 1,), SENTINEL, dtype=torch.int32, device=ids.device)
    uniq.scatter_(0, slot, s)
    uniq = uniq[:size]
    return uniq, uniq != SENTINEL


@hook
class DeduplicationHook(SeedableHook, StatelessHook):
    """Deduplicate a batch's node ids into a compact local index space.

    Produces ``unique_nids`` (U,) int32, sorted, PAD-filled at the tail;
    ``num_unique`` () int32; and ``global_to_local`` (num_nodes + 1,) int32,
    the local row of each id, -1 for unseen ids and the PAD slot.
    """

    _cls_requires = {"edge_src", "edge_dst"}
    _cls_produces = {"unique_nids", "num_unique", "global_to_local"}

    def __init__(
        self,
        num_nodes: int,
        seed_nodes_keys: Optional[List[str]] = None,
        id: Optional[str] = None,
    ) -> None:
        super().__init__(seed_keys=seed_nodes_keys, id=id)
        self._num_nodes = num_nodes

    def apply(self, state: Any, batch: DGBatch) -> Tuple[Any, DGBatch]:
        nids = [batch.edge_src, batch.edge_dst]
        for attr in sorted(self.requires):
            if attr in ("edge_src", "edge_dst"):
                continue
            if not batch.has(attr):
                raise ValueError(f"Missing seed node attribute {attr}")
            value = getattr(batch, attr)
            if "nbr_nids" in attr:
                nids.extend(hop.reshape(-1) for hop in value)
            else:
                nids.append(value.reshape(-1))
        all_nids = torch.cat(nids)
        n = self._num_nodes
        # At most n distinct valid ids, +1 slot so the sentinel never evicts one.
        U = min(all_nids.shape[0], n + 1)
        uniq, valid = sorted_unique(all_nids, n, U)
        unique_nids = torch.where(valid, uniq, PADDED_NODE_ID)
        g2l = torch.full((n + 1,), -1, dtype=torch.int32, device=all_nids.device)
        local = torch.arange(U, dtype=torch.int32, device=all_nids.device)
        g2l.scatter_(0, torch.where(valid, uniq, n).long(), torch.where(valid, local, -1))
        g2l[n] = -1
        self.add_batch_attribute(batch, "unique_nids", unique_nids)
        self.add_batch_attribute(batch, "num_unique", valid.sum(dtype=torch.int32))
        self.add_batch_attribute(batch, "global_to_local", g2l)
        return state, batch

    def __call__(self, dg: DGraph, batch: DGBatch) -> DGBatch:
        _, batch = self.apply(None, batch)
        return batch


def map_to_local(g2l: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Map global ids through a dense (num_nodes + 1,) table (PAD-safe)."""
    n = g2l.shape[0] - 1
    return g2l[torch.where((ids >= 0) & (ids < n), ids, n).long()]


def local_rows(g2l: torch.Tensor, ids: torch.Tensor, num_rows: int) -> torch.Tensor:
    """int64 rows of ``ids`` in a (num_rows, ...) local table: ``map_to_local``,
    with -1 (an unseen id) wrapped to row ``num_rows - 1`` as a JAX gather
    wraps it. Masks drop those rows; no -1 reaches an index."""
    rows = map_to_local(g2l, ids).long()
    return torch.where(rows < 0, rows + num_rows, rows)


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
