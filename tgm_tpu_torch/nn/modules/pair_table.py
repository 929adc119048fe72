"""A sorted table of (src, dst) pair keys with an int64 value each, on the device.

EdgeBank keeps each pair's latest time in one, t-CoMem each pair's
co-occurrence count. A key is ``src << 32 | dst`` for non-negative int32
ids; a pair with a negative id (``PADDED_NODE_ID``) keys as ``SENTINEL``,
which is never stored and never found. The table is a fixed-capacity
array sorted ascending and padded with ``SENTINEL``, so a lookup is one
``searchsorted`` and a merge of a batch moves every row by a scatter to
its merged position (a ``searchsorted`` and a cumulative count), with no
sort of the table and no wait for the card. Only growing the table reads
its size back: the host keeps an upper bound on the rows in use (each merge
adds its batch's length) and asks the card when the bound would pass the
capacity, then doubles it if the rows in use pass half of it.
"""

from __future__ import annotations

import torch

SENTINEL = torch.iinfo(torch.int64).max
_MIN_CAPACITY = 1024


def pair_keys(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``src << 32 | dst`` as int64, ``SENTINEL`` where either id is negative."""
    s, d = src.long(), dst.long()
    return torch.where((s >= 0) & (d >= 0), (s << 32) | d, SENTINEL)


def capacity_for(n: int) -> int:
    """The smallest power of two, at least ``_MIN_CAPACITY``, that holds 2n rows."""
    c = _MIN_CAPACITY
    while c < 2 * n:
        c *= 2
    return c


class SortedPairTable:
    """Pair keys sorted ascending with an int64 value each, ``capacity``
    rows on ``device``. Row ``capacity`` is a dump row: its key stays
    ``SENTINEL``, and writes that have no row go there."""

    def __init__(self, device: torch.device, capacity: int = _MIN_CAPACITY) -> None:
        self.device = device
        self._keys = torch.full((capacity + 1,), SENTINEL, dtype=torch.int64, device=device)
        self._vals = torch.zeros(capacity + 1, dtype=torch.int64, device=device)
        self._bound = 0  # rows in use are at most this many
        self.size_reads = 0  # times the host read the size back (each waits for the card)

    @property
    def capacity(self) -> int:
        return self._keys.numel() - 1

    def size(self) -> int:
        """Rows in use (waits for the card)."""
        self.size_reads += 1
        return int(torch.searchsorted(self._keys, SENTINEL))

    def items(self):
        """Copies of the keys and values in use, on the table's device
        (waits for the card)."""
        n = self.size()
        return self._keys[:n].clone(), self._vals[:n].clone()

    def lookup(self, keys: torch.Tensor):
        """``(hit, row)``: whether each key is in the table and its row
        (the dump row's index where it is not)."""
        row = torch.searchsorted(self._keys, keys).clamp_(max=self.capacity)
        hit = (self._keys[row] == keys) & (keys != SENTINEL)
        return hit, torch.where(hit, row, self.capacity)

    def values(self, row: torch.Tensor) -> torch.Tensor:
        return self._vals[row]

    def _reserve(self, m: int) -> None:
        """Room for ``m`` more rows; reads the size back only when the
        host's bound would pass the capacity."""
        if self._bound + m <= self.capacity:
            self._bound += m
            return
        n = self.size()
        if 2 * (n + m) > self.capacity:
            cap = capacity_for(n + m)
            keys = torch.full((cap + 1,), SENTINEL, dtype=torch.int64, device=self.device)
            vals = torch.zeros(cap + 1, dtype=torch.int64, device=self.device)
            keys[:n], vals[:n] = self._keys[:n], self._vals[:n]
            self._keys, self._vals = keys, vals
        self._bound = n + m

    def merge(self, keys: torch.Tensor, vals: torch.Tensor, reduce: str) -> None:
        """Fold a batch of (key, value) rows in: ``reduce`` ("sum" or
        "amax") combines the values of one key, in the batch and with the
        table's. ``SENTINEL`` keys are skipped."""
        M = keys.numel()
        self._reserve(M)
        C = self.capacity
        # The batch's distinct keys, ascending, each with its combined value;
        # the slots past them hold SENTINEL.
        ks, order = torch.sort(keys)
        first = torch.ones(M, dtype=torch.bool, device=self.device)
        first[1:] = ks[1:] != ks[:-1]
        seg = torch.cumsum(first, 0) - 1
        uk = torch.full((M,), SENTINEL, dtype=torch.int64, device=self.device).scatter_(0, seg, ks)
        uv = torch.zeros(M, dtype=torch.int64, device=self.device).scatter_reduce_(
            0, seg, vals.long()[order], reduce, include_self=False)

        hit, row = self.lookup(uk)
        if reduce == "sum":
            self._vals.index_add_(0, row, torch.where(hit, uv, 0))
        else:
            self._vals.scatter_reduce_(0, row, uv, reduce)
        # New keys: each goes before the row searchsorted names, after the new
        # keys that precede it; each old row moves up by the new keys at or
        # before it. The merged order is a bijection onto [0, C) plus rows past
        # C, all SENTINEL padding, which go to the dump row.
        new = ~hit & (uk != SENTINEL)
        at = torch.searchsorted(self._keys, uk)
        moved = torch.zeros(C + 1, dtype=torch.int64, device=self.device).index_add_(
            0, torch.where(new, at, C), new.long())
        dest_old = (torch.arange(C + 1, device=self.device) + torch.cumsum(moved, 0)).clamp_(max=C)
        dest_new = torch.where(new, at + torch.cumsum(new, 0) - 1, C)
        out_k = torch.empty_like(self._keys).scatter_(0, dest_old, self._keys)
        out_v = torch.empty_like(self._vals).scatter_(0, dest_old, self._vals)
        out_k.scatter_(0, dest_new, uk)
        out_v.scatter_(0, dest_new, uv)
        out_k[C:].fill_(SENTINEL)  # a fill, not a copy from the host
        self._keys, self._vals = out_k, out_v


__all__ = ["SENTINEL", "SortedPairTable", "capacity_for", "pair_keys"]
