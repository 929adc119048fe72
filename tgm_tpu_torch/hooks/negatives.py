"""Negative edge samplers (port of ``tgm_tpu/hooks/negatives.py``).

* ``RandomNegativeEdgeSamplerHook``: uniform random destination ids in
  [low, high) for training, ``neg_time = edge_time``.
* ``HistoricalNegativeEdgeSamplerHook``: per source, one destination drawn
  uniformly from that source's logged past edges (a Gumbel-max over a
  preallocated edge log), PAD and ``valid_neg_mask`` False without history.
* ``TGBNegativeEdgeSamplerHook`` and its THG / TKG variants serve
  pre-generated per-edge candidate lists in order, given as a dense
  ``(E_eval, Q)`` array or loaded from the installed ``tgb`` package.

Random draws come from seeded ``torch.Generator`` objects, so the card and
the CPU see the same numbers where the generator is on the CPU (the random
ids and the TGB link times); the historical sampler's weights come from a
generator on the hook's device.
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


def _last_writer(target: torch.Tensor, size: int) -> torch.Tensor:
    """For each write, the row of the last write in row order to the same
    target: the rule of an XLA scatter with repeated indices. Writing every
    row's value from that row makes repeated targets agree on any device."""
    order = torch.arange(target.shape[0], device=target.device)
    last = torch.full((size,), -1, dtype=torch.long, device=target.device)
    last.scatter_reduce_(0, target, order, "amax")
    return last[target]


@hook
class HistoricalNegativeEdgeSamplerHook(StatefulHook):
    """Sample negatives from each source's historical destinations.

    State: ``(generator, src_log, dst_log, count)`` with a static capacity C
    equal to the graph's edge-event count: every batch appends its valid
    edges at ``count + cumsum(valid) - 1`` and ``count`` is clamped at C.
    Per batch, each logged edge gets a uniform weight (:meth:`draw_weights`,
    from the generator on the hook's device; tests replace it), and each
    source's winner is its logged edge of largest weight (ties: the largest
    log index), found with two ``scatter_reduce_("amax")`` passes; a source
    without history gets PAD and ``valid_neg_mask`` False.
    """

    _cls_requires = {"edge_src", "edge_dst", "edge_time"}
    _cls_produces = {"neg", "neg_time", "valid_neg_mask"}

    def __init__(self, device: DeviceLike = None, seed: int = 0,
                 id: Optional[str] = None) -> None:
        super().__init__(id=id)
        self.device = resolve_device(device)
        self._seed = seed
        self._num_nodes: Optional[int] = None

    def init_state(self, dg: Optional[DGraph] = None) -> Any:
        if dg is None:
            raise ValueError("HistoricalNegativeEdgeSamplerHook needs a graph to size its log")
        capacity = int(dg.num_edge_events)
        self._num_nodes = int(dg.num_nodes)
        i32 = dict(dtype=torch.int32, device=self.device)
        return (
            torch.Generator(device=self.device).manual_seed(self._seed),
            torch.full((capacity,), PADDED_NODE_ID, **i32),
            torch.full((capacity,), PADDED_NODE_ID, **i32),
            torch.zeros((), **i32),
        )

    def draw_weights(self, generator: torch.Generator, C: int) -> torch.Tensor:
        """(C,) float32 weights uniform in [0, 1) on the hook's device."""
        return torch.rand((C,), generator=generator, device=self.device)

    def apply(self, state: Any, batch: DGBatch) -> Tuple[Any, DGBatch]:
        generator, src_log, dst_log, count = state
        n = self._num_nodes
        C = src_log.shape[0]
        dev = src_log.device
        idx = torch.arange(C, device=dev)
        filled = idx < count
        # Empty slots go to bucket n; so do slots whose id falls outside
        # [0, n], which JAX's segment_max drops (bucket n is never read).
        seg = torch.where(filled, src_log, n).long()
        seg = torch.where((seg >= 0) & (seg <= n), seg, n)
        w = torch.where(filled, self.draw_weights(generator, C), -1.0)
        best_w = torch.full((n + 1,), float("-inf"), device=dev).scatter_reduce_(
            0, seg, w, "amax")
        is_best = filled & (w == best_w[seg])
        best_idx = torch.full((n + 1,), -1, dtype=torch.long, device=dev).scatter_reduce_(
            0, seg, torch.where(is_best, idx, -1), "amax")

        src = batch.edge_src.clamp(0, n - 1).long()
        has_hist = best_idx[src] >= 0
        neg = torch.where(has_hist, dst_log[best_idx[src].clamp(0, C - 1)], PADDED_NODE_ID)
        valid = has_hist
        if batch.edge_valid is not None:
            valid = valid & batch.edge_valid
            neg = torch.where(batch.edge_valid, neg, PADDED_NODE_ID)

        # Append the valid edges. Padded rows aim past the log, at its last
        # slot, and write back its old value; the last write in row order
        # wins, as in JAX, so once the log fills its last edge is lost.
        B = batch.edge_src.shape[0]
        if batch.edge_valid is not None:
            pos = torch.cumsum(batch.edge_valid.int(), 0) - 1
            write_pos = torch.where(batch.edge_valid, count + pos, C)
            n_new = batch.edge_valid.sum(dtype=torch.int32)
        else:
            write_pos = count + torch.arange(B, device=dev)
            n_new = B
        target = write_pos.clamp(0, C - 1).long()
        winner = _last_writer(target, C)
        inside = write_pos < C
        for log, vals in ((src_log, batch.edge_src), (dst_log, batch.edge_dst)):
            log[target] = torch.where(inside, vals, log[target])[winner]
        count = torch.clamp_max(count + n_new, C).int()

        self.add_batch_attribute(batch, "neg", neg)
        self.add_batch_attribute(batch, "neg_time", batch.edge_time)
        self.add_batch_attribute(batch, "valid_neg_mask", valid)
        return (generator, src_log, dst_log, count), batch


class _TGBEvalNegativesBase(StatefulHook):
    """Serve pre-generated negative candidate lists in chronological order.

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
    _dataset_prefix = "tgbl"

    def __init__(
        self,
        candidates: Optional[np.ndarray] = None,
        device: DeviceLike = None,
        seed: int = 0,
        id: Optional[str] = None,
        dataset_name: Optional[str] = None,
        split_mode: Optional[str] = None,
    ) -> None:
        super().__init__(id=id)
        if candidates is None:
            if dataset_name is None or split_mode is None:
                raise ValueError("Provide either (dataset_name, split_mode) or candidates")
            candidates = self._load_from_tgb(dataset_name, split_mode)
        self.split_mode = split_mode
        candidates = np.asarray(candidates)
        if candidates.ndim != 2:
            raise ValueError(f"candidates must be (E_eval, Q), got {candidates.shape}")
        self.device = resolve_device(device)
        self._candidates = torch.as_tensor(candidates.astype(np.int32), device=self.device)
        self._seed = seed
        self._generator: Optional[torch.Generator] = None

    def _load_from_tgb(self, dataset_name: str, split_mode: str) -> np.ndarray:
        """The split's candidate lists from the installed ``tgb`` package, as
        a PAD-padded (E_eval, Q) array in chronological order."""
        if split_mode not in ("val", "test"):
            raise ValueError(f'split_mode must be "val" or "test", got: {split_mode}')
        if not dataset_name.startswith(f"{self._dataset_prefix}-"):
            raise ValueError(f"{type(self).__name__} expects {self._dataset_prefix}-* datasets, "
                             f"got {dataset_name}")
        try:
            from pathlib import Path

            from tgb.utils.info import DATA_VERSION_DICT, PROJ_DIR
        except ImportError as e:
            raise ImportError(
                f"TGB required for {type(self).__name__}, try `pip install py-tgb`") from e
        sampler = self._build_sampler(dataset_name)
        root = Path(PROJ_DIR + "datasets") / dataset_name.replace("-", "_")
        v = DATA_VERSION_DICT.get(dataset_name, 1)
        suffix = f"_v{v}" if v > 1 else ""
        fname = root / f"{dataset_name}_{split_mode}_ns{suffix}.pkl"
        sampler.load_eval_set(fname=str(fname), split_mode=split_mode)
        rows = list(sampler.eval_set[split_mode].values())
        out = np.full((len(rows), max(len(r) for r in rows)), PADDED_NODE_ID, dtype=np.int64)
        for i, r in enumerate(rows):
            out[i, : len(r)] = np.asarray(r)
        return out

    def _build_sampler(self, dataset_name: str) -> Any:
        from tgb.linkproppred.negative_sampler import NegativeEdgeSampler

        return NegativeEdgeSampler(dataset_name=dataset_name)

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


@hook
class TGBNegativeEdgeSamplerHook(_TGBEvalNegativesBase):
    """tgbl-* pre-generated negative sets."""

    _dataset_prefix = "tgbl"


@hook
class TGBTHGNegativeEdgeSamplerHook(_TGBEvalNegativesBase):
    """thgl-* heterogeneous pre-generated negative sets (type-constrained)."""

    _dataset_prefix = "thgl"

    def _build_sampler(self, dataset_name: str) -> Any:
        from tgb.linkproppred.dataset import LinkPropPredDataset
        from tgb.linkproppred.thg_negative_sampler import THGNegativeEdgeSampler

        dataset = LinkPropPredDataset(name=dataset_name)
        return THGNegativeEdgeSampler(dataset_name=dataset_name,
                                      first_dst_id=dataset.min_dst_idx,
                                      last_dst_id=dataset.max_dst_idx,
                                      node_type=dataset.node_type)


@hook
class TGBTKGNegativeEdgeSamplerHook(_TGBEvalNegativesBase):
    """tkgl-* knowledge-graph pre-generated negative sets (dst-id range)."""

    _dataset_prefix = "tkgl"

    def _build_sampler(self, dataset_name: str) -> Any:
        from tgb.linkproppred.dataset import LinkPropPredDataset
        from tgb.linkproppred.tkg_negative_sampler import TKGNegativeEdgeSampler

        dataset = LinkPropPredDataset(name=dataset_name)
        return TKGNegativeEdgeSampler(dataset_name=dataset_name,
                                      first_dst_id=dataset.min_dst_idx,
                                      last_dst_id=dataset.max_dst_idx,
                                      strategy="time-filtered")
