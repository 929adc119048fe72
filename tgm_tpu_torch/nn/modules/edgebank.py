"""EdgeBank, the parameter-free memory baseline (port of
``tgm_tpu/nn/modules/edgebank.py``).

The memory is a ``SortedPairTable`` on the device: one row per pair key
ever updated, holding the key's latest time. A query is a
``searchsorted``: ``pos_prob`` where the key is stored (and, in
``"fixed"`` mode, its latest time is at or after the window start), else
0, as float32. Fixed mode needs only the latest time, since the JAX
package reads the last entry of the key's time-sorted run.

Keys are the JAX package's: ``src * base + dst`` in int64, where ``base``
is one more than the largest id seen so far in updates and queries alike
(at least 1). When an update or a query raises ``base``, every stored key
is re-keyed as JAX does it (``key // old * base + key % old``, floor
division), and keys that meet on one value keep their latest time. So a
padded row (``PADDED_NODE_ID``) or any negative id is stored and answered
as the JAX package stores and answers it: a query such as (1, -1) can read
the key of another pair. Reading ``base``'s growth back waits for the
card once an update or query.

The window: ``window_start = t_max - window_ratio * (t_max - t_min)`` over
every row of the constructor's edges, then ``window_end - window_size``
after each update, whose rows all move ``window_end``, as in JAX; all in
fp64 on the device (an int64 tensor compared with a Python float would be
compared in float32).
"""

from __future__ import annotations

from typing import Literal

import torch

from ...device import DeviceLike, resolve_device
from .pair_table import SortedPairTable, capacity_for

INT64_MIN = torch.iinfo(torch.int64).min


def as_long(x, device: torch.device) -> torch.Tensor:
    """``x`` (a tensor or anything ``torch.as_tensor`` reads) as int64 on ``device``."""
    return torch.as_tensor(x, device=device).long()


def check_edges(src: torch.Tensor, dst: torch.Tensor, ts: torch.Tensor) -> None:
    if not (len(src) == len(dst) == len(ts)):
        raise ValueError(f"mismatched shapes: {len(src)}, {len(dst)}, {len(ts)}")
    if len(src) == 0:
        raise ValueError("src, dst, ts must be non-empty")


def valid_edges(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """The rows that are not padding: both ids non-negative."""
    return (src >= 0) & (dst >= 0)


def time_range(ts: torch.Tensor, valid: torch.Tensor):
    """(min, max) of the valid rows' times as Python ints (waits for the card)."""
    big = torch.iinfo(torch.int64).max
    lo = torch.where(valid, ts, big).min()
    hi = torch.where(valid, ts, INT64_MIN).max()
    return int(lo), int(hi)


class EdgeBankPredictor:
    """EdgeBank over the edges ``(src, dst, ts)``, its state on ``device``
    (default the card)."""

    def __init__(
        self,
        src,
        dst,
        ts,
        memory_mode: Literal["unlimited", "fixed"] = "unlimited",
        window_ratio: float = 0.15,
        pos_prob: float = 1.0,
        device: DeviceLike = None,
    ) -> None:
        if memory_mode not in ("unlimited", "fixed"):
            raise ValueError('memory_mode must be "unlimited" or "fixed"')
        if not 0 < window_ratio <= 1.0:
            raise ValueError("Window ratio must be in (0, 1]")
        self.device = resolve_device(device)
        src, dst, ts = (as_long(x, self.device) for x in (src, dst, ts))
        check_edges(src, dst, ts)

        self.pos_prob = float(pos_prob)
        self._window_ratio = float(window_ratio)
        self._fixed_memory = memory_mode == "fixed"

        t_min, t_max = int(ts.min()), int(ts.max())
        if self._fixed_memory:
            window_start = t_max - window_ratio * (t_max - t_min)
        else:
            window_start = t_min
        self._window_size = t_max - window_start
        self._window_end = torch.tensor(t_max, dtype=torch.int64, device=self.device)
        self._window_start = torch.tensor(window_start, dtype=torch.float64, device=self.device)
        self.memory = SortedPairTable(self.device, capacity_for(len(src)))
        self._pair_base = 1  # grows with the largest id seen
        self.update(src, dst, ts)

    def _key(self, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
        """``src * base + dst`` after raising ``base`` to cover this call's
        ids, re-keying the table first when it grows (the JAX ``_key``)."""
        m = int(torch.maximum(src.max(), dst.max()).clamp_min(0)) + 1 if src.numel() else 1
        if m > self._pair_base:
            old, self._pair_base = self._pair_base, m
            keys, vals = self.memory.items()
            if keys.numel():
                keys = torch.div(keys, old, rounding_mode="floor") * m + torch.remainder(keys, old)
                table = SortedPairTable(self.device, self.memory.capacity)
                table.merge(keys, vals, "amax")
                self.memory = table
        return src * self._pair_base + dst

    def update(self, src, dst, ts) -> None:
        """Store a batch of edges, every row keyed as the JAX package keys
        it, and advance the window."""
        src, dst, ts = (as_long(x, self.device) for x in (src, dst, ts))
        check_edges(src, dst, ts)
        self._window_end = torch.maximum(self._window_end, ts.max())
        if self._fixed_memory:
            self._window_start = self._window_end.double() - self._window_size
        keys = self._key(src, dst)  # may replace self.memory: key before binding merge
        self.memory.merge(keys, ts, "amax")

    def __call__(self, query_src, query_dst) -> torch.Tensor:
        """float32 ``pos_prob`` for each queried key in (windowed) memory, else 0."""
        q = self._key(as_long(query_src, self.device), as_long(query_dst, self.device))
        hit, row = self.memory.lookup(q)
        if self._fixed_memory:
            hit &= self.memory.values(row).double() >= self._window_start
        return torch.where(hit, self.pos_prob, 0.0).float()

    @property
    def window_start(self) -> float:
        return float(self._window_start)

    @property
    def window_end(self) -> int:
        return int(self._window_end)

    @property
    def window_ratio(self) -> float:
        return self._window_ratio


__all__ = ["EdgeBankPredictor"]
