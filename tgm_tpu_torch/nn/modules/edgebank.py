"""EdgeBank, the parameter-free memory baseline (port of
``tgm_tpu/nn/modules/edgebank.py``).

The memory is a ``SortedPairTable`` on the device: one row per (src, dst)
pair ever updated, holding the pair's latest time. A query is a
``searchsorted``: ``pos_prob`` where the pair is stored (and, in
``"fixed"`` mode, its latest time is at or after the window start), else
0, as float32. Fixed mode needs only the latest time, since the JAX
package reads the last entry of the pair's time-sorted run.

The window: ``window_start = t_max - window_ratio * (t_max - t_min)`` over
the constructor's edges, then ``window_end - window_size`` after each
update, all in fp64 on the device (an int64 tensor compared with a Python
float would be compared in float32).

Rows whose src or dst is negative (``PADDED_NODE_ID``) are padding: an
update skips them, and a query of one answers 0. So a padded batch goes
in whole, with no mask that would wait for the card. (The JAX package's
composite key aliases such a query onto a stored pair: ROADMAP fault 24.)
"""

from __future__ import annotations

from typing import Literal

import torch

from ...device import DeviceLike, resolve_device
from .pair_table import SortedPairTable, capacity_for, pair_keys

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

        t_min, t_max = time_range(ts, valid_edges(src, dst))
        if self._fixed_memory:
            window_start = t_max - window_ratio * (t_max - t_min)
        else:
            window_start = t_min
        self._window_size = t_max - window_start
        self._window_end = torch.tensor(t_max, dtype=torch.int64, device=self.device)
        self._window_start = torch.tensor(window_start, dtype=torch.float64, device=self.device)
        self.memory = SortedPairTable(self.device, capacity_for(len(src)))
        self.update(src, dst, ts)

    def update(self, src, dst, ts) -> None:
        """Store a batch of edges (padding rows skipped) and advance the window."""
        src, dst, ts = (as_long(x, self.device) for x in (src, dst, ts))
        check_edges(src, dst, ts)
        t_hi = torch.where(valid_edges(src, dst), ts, INT64_MIN).max()
        self._window_end = torch.maximum(self._window_end, t_hi)
        if self._fixed_memory:
            self._window_start = self._window_end.double() - self._window_size
        self.memory.merge(pair_keys(src, dst), ts, "amax")

    def __call__(self, query_src, query_dst) -> torch.Tensor:
        """float32 ``pos_prob`` for each queried pair in (windowed) memory, else 0."""
        q = pair_keys(as_long(query_src, self.device), as_long(query_dst, self.device))
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
