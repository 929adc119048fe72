"""Negative edge samplers (port of ``tgm_tpu/hooks/negatives.py``).

* ``RandomNegativeEdgeSamplerHook``: uniform random destination ids in
  [low, high) for training, ``neg_time = edge_time``.
* ``TGBNegativeEdgeSamplerHook`` serves pre-generated per-edge candidate
  lists in order, given as a dense ``(E_eval, Q)`` array.

Random draws come from seeded CPU ``torch.Generator`` objects and are moved
to the hook's device, so the card and the CPU see the same numbers. Loading
candidates from the TGB package, the THG/TKG variants and the historical
sampler are queued in ROADMAP.md.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..constants import PADDED_NODE_ID
from ..core.batch import DGBatch
from ..core.graph import DGraph
from ..device import DeviceLike, resolve_device
from .base import StatefulHook
from .registry import hook

_INT32_MAX = int(np.iinfo(np.int32).max)


def unique_padded(x: torch.Tensor) -> torch.Tensor:
    """Sorted unique non-PAD values of ``x``, PAD-padded to ``x.numel()``.

    Static-width form of ``jnp.unique(..., size=n)``: a sort, a first-of-run
    mask and a second sort, with no host round trip for the count.
    """
    flat = x.reshape(-1)
    keyed = torch.where(flat == PADDED_NODE_ID, _INT32_MAX, flat)
    s, _ = torch.sort(keyed)
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    s, _ = torch.sort(torch.where(first, s, _INT32_MAX))
    return torch.where(s == _INT32_MAX, PADDED_NODE_ID, s)


@hook
class RandomNegativeEdgeSamplerHook(StatefulHook):
    """Uniform random negative destinations for link-prediction training.

    Each batch of B edges gets ``size = max(1, round(neg_ratio * B))`` ids
    uniform in [low, high) (``high`` exclusive), PAD where the batch row is
    padding, with ``neg_time = edge_time[:size]`` and ``neg_valid =
    edge_valid[:size]``. The state is the seeded generator :meth:`draw_neg`
    draws from; ``reset_state`` re-seeds it.
    """

    _cls_requires = {"edge_src", "edge_dst", "edge_time"}
    _cls_produces = {"neg", "neg_time"}

    def __init__(
        self,
        low: int,
        high: int,
        neg_ratio: float = 1.0,
        device: DeviceLike = None,
        seed: int = 0,
        id: Optional[str] = None,
    ) -> None:
        super().__init__(id=id)
        if not 0 < neg_ratio <= 1:
            raise ValueError(f"neg_ratio must be in (0, 1], got: {neg_ratio}")
        if not low < high:
            raise ValueError(f"low ({low}) must be strictly less than high ({high})")
        self.low = low
        self.high = high
        self.neg_ratio = neg_ratio
        self.device = resolve_device(device)
        self._seed = seed
        self._generator: Optional[torch.Generator] = None

    def init_state(self, dg: Optional[DGraph] = None) -> Any:
        self._generator = torch.Generator().manual_seed(self._seed)
        return self._generator

    def draw_neg(self, size: int) -> torch.Tensor:
        """``size`` int32 ids uniform in [low, high), on the hook's device.

        Tests replace this method to inject ids.
        """
        if self._generator is None:
            self.init_state()
        r = torch.randint(self.low, self.high, (size,), generator=self._generator,
                          dtype=torch.int32)
        return r.to(self.device)

    def apply(self, state: Any, batch: DGBatch) -> Tuple[Any, DGBatch]:
        size = max(1, round(self.neg_ratio * batch.edge_dst.shape[0]))
        neg = self.draw_neg(size)
        if batch.edge_valid is not None:
            # A real id on a padded row would add a live seed to the batch.
            neg = torch.where(batch.edge_valid[:size], neg, PADDED_NODE_ID)
            self.add_batch_attribute(batch, "neg_valid", batch.edge_valid[:size])
        self.add_batch_attribute(batch, "neg", neg)
        self.add_batch_attribute(batch, "neg_time", batch.edge_time[:size])
        return state, batch

    def reset_state(self) -> None:
        self.state = None
        self._generator = None


@hook
class TGBNegativeEdgeSamplerHook(StatefulHook):
    """Serve tgbl-* pre-generated negative candidate lists in chronological order.

    State is a cursor into the candidate rows, advanced by the count of valid
    edges of each batch. Produces:

    * ``neg_batch_list`` (B, Q): this batch's candidates, PAD on padded rows;
    * ``neg`` (B*Q,): the unique candidates, sorted ascending, PAD-padded to
      B*Q, so the recency seed layout stays [src | dst | B*Q];
    * ``neg_valid`` (B, Q) and ``neg_time`` (B*Q,): fake link times drawn
      inside the batch's time range by :meth:`draw_neg_time`.
    """

    _cls_requires = {"edge_src", "edge_dst", "edge_time"}
    _cls_produces = {"neg", "neg_batch_list", "neg_time", "neg_valid"}

    def __init__(
        self,
        candidates: np.ndarray,
        device: DeviceLike = None,
        seed: int = 0,
        id: Optional[str] = None,
    ) -> None:
        super().__init__(id=id)
        candidates = np.asarray(candidates)
        if candidates.ndim != 2:
            raise ValueError(f"candidates must be (E_eval, Q), got {candidates.shape}")
        self.device = resolve_device(device)
        self._candidates = torch.as_tensor(candidates.astype(np.int32), device=self.device)
        self._seed = seed
        self._generator: Optional[torch.Generator] = None

    def init_state(self, dg: Optional[DGraph] = None) -> Any:
        self._generator = torch.Generator().manual_seed(self._seed)
        return torch.zeros((), dtype=torch.int32, device=self.device)

    def draw_neg_time(self, n: int, t_lo: torch.Tensor, t_hi: torch.Tensor) -> torch.Tensor:
        """``n`` link times uniform in [t_lo, t_hi], on the hook's device.

        The draws come from a seeded CPU generator, so the card and the CPU
        see the same numbers. Tests replace this method to inject times.
        """
        if self._generator is None:
            self._generator = torch.Generator().manual_seed(self._seed)
        r = torch.randint(0, _INT32_MAX, (n,), generator=self._generator, dtype=torch.int64)
        span = (t_hi.long() - t_lo.long() + 1).clamp_min(1)
        return (t_lo.long() + r.to(self.device) % span).int()

    def apply(self, state: Any, batch: DGBatch) -> Tuple[Any, DGBatch]:
        cursor = state
        B = batch.edge_src.shape[0]
        E_eval, Q = self._candidates.shape
        dev = self._candidates.device
        # Row gather, not a clamped slice: a clamp would shift a partial tail
        # batch's window backwards and re-serve earlier edges' candidates.
        row_idx = cursor + torch.arange(B, dtype=torch.int32, device=dev)
        in_range = row_idx < E_eval
        rows = self._candidates[row_idx.clamp(0, E_eval - 1).long()]
        rows = torch.where(in_range[:, None], rows, PADDED_NODE_ID)
        if batch.edge_valid is not None:
            rows = torch.where(batch.edge_valid[:, None], rows, PADDED_NODE_ID)
            n_valid = batch.edge_valid.sum(dtype=torch.int32)
            t_lo = torch.where(batch.edge_valid, batch.edge_time, _INT32_MAX).min()
            t_hi = torch.where(batch.edge_valid, batch.edge_time, 0).max()
        else:
            n_valid = B
            t_lo, t_hi = batch.edge_time.min(), batch.edge_time.max()
        neg = unique_padded(rows)
        neg_time = self.draw_neg_time(neg.shape[0], t_lo, t_hi)
        neg_time = torch.where(neg != PADDED_NODE_ID, neg_time, 0)
        self.add_batch_attribute(batch, "neg", neg)
        self.add_batch_attribute(batch, "neg_batch_list", rows)
        self.add_batch_attribute(batch, "neg_valid", rows != PADDED_NODE_ID)
        self.add_batch_attribute(batch, "neg_time", neg_time)
        return cursor + n_valid, batch

    def reset_state(self) -> None:
        self.state = None
        self._generator = None
