"""TGB evaluation negatives (port of ``tgm_tpu/hooks/negatives.py``).

``TGBNegativeEdgeSamplerHook`` serves pre-generated per-edge candidate lists
in order, given as a dense ``(E_eval, Q)`` array. Loading them from the TGB
package, the THG/TKG variants and the training samplers are queued in
ROADMAP.md.
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
