"""Batch- and node-level analytics hooks (port of ``tgm_tpu/hooks/analytics.py``).

``BatchAnalyticsHook`` gives per-batch counts (events, unique timestamps and
nodes, average degree, repeated events); ``NodeAnalyticsHook`` per-tracked-
node degree, activity, lifetime and appearance statistics and the batch's
edge novelty and density. All state is fixed-shape tensors: first / last
seen times and appearance counters are (N+1,) vectors and the seen-edge set
is a bitmap of 32-bit words (int32 holding the JAX uint32 words' bits).
The bitmap is keyed exactly by the (src, dst) pair whenever the (N+1)^2
pair space fits 2^26 bits (8 MiB), and by a single multiplicative hash of
the pair otherwise (collisions undercount new edges; ``novelty_is_exact``
and the bitmap's load factor report it). Unique counts sort and count run
starts on the device, so no hook waits for the card.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..core.batch import DGBatch
from ..core.graph import DGraph
from ..device import DeviceLike, resolve_device
from .base import StatefulHook, StatelessHook
from .registry import hook

_INT32_MAX = int(np.iinfo(np.int32).max)
_INT32_MIN = int(np.iinfo(np.int32).min)


def _masked_unique_count(x: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Number of distinct values of ``x`` where ``valid`` (INT32_MAX excluded)."""
    keyed = x if valid is None else torch.where(valid, x, _INT32_MAX)
    s, _ = torch.sort(keyed.reshape(-1))
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    return (first & (s != _INT32_MAX)).sum(dtype=torch.int32)


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to int32 with two's-complement wrap-around."""
    return (torch.remainder(x + 2**31, 2**32) - 2**31).int()


def _popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (its 32 bits as unsigned), as int64."""
    x = words.long() & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _and_valid(parts):
    """Concatenated validity of (values, valid-or-None) parts, or None if none has one."""
    if all(v is None for _, v in parts):
        return None
    return torch.cat([torch.ones(x.shape[0], dtype=torch.bool, device=x.device) if v is None
                      else v for x, v in parts])


@hook
class BatchAnalyticsHook(StatelessHook):
    """Simple per-batch statistics (0-dim tensors on the batch's device)."""

    _cls_requires = {"edge_src", "edge_dst", "edge_time"}
    _cls_produces = {
        "num_edge_events",
        "num_node_events",
        "num_unique_timestamps",
        "num_unique_nodes",
        "avg_degree",
        "num_repeated_edge_events",
        "num_repeated_node_events",
    }

    def apply(self, state: Any, batch: DGBatch) -> Tuple[Any, DGBatch]:
        ev = batch.edge_valid
        dev = batch.edge_src.device
        i32 = lambda v: torch.full((), v, dtype=torch.int32, device=dev)
        n_edges = i32(batch.edge_src.shape[0]) if ev is None else ev.sum(dtype=torch.int32)
        node_x_nids = getattr(batch, "node_x_nids", None)
        node_x_valid = getattr(batch, "node_x_valid", None)
        node_x_time = getattr(batch, "node_x_time", None)
        if node_x_nids is not None:
            n_nodes_ev = (i32(node_x_nids.shape[0]) if node_x_valid is None
                          else node_x_valid.sum(dtype=torch.int32))
        else:
            n_nodes_ev = i32(0)

        ts = [(batch.edge_time, ev)]
        if node_x_time is not None:
            ts.append((node_x_time, node_x_valid))
        n_unique_ts = _masked_unique_count(torch.cat([t for t, _ in ts]), _and_valid(ts))

        nids = [(batch.edge_src, ev), (batch.edge_dst, ev)]
        if node_x_nids is not None:
            nids.append((node_x_nids, node_x_valid))
        n_unique_nodes = _masked_unique_count(torch.cat([x for x, _ in nids]), _and_valid(nids))
        avg_degree = torch.where(n_unique_nodes > 0,
                                 2.0 * n_edges.float() / n_unique_nodes.clamp_min(1).float(),
                                 0.0)

        # Repeated edge events: sort by (src, dst, time) and count adjacent
        # duplicate triplets of valid rows.
        order = torch.argsort(batch.edge_time, stable=True)
        for key in (batch.edge_dst, batch.edge_src):
            order = order[torch.argsort(key[order], stable=True)]
        s1, s2, s3 = batch.edge_src[order], batch.edge_dst[order], batch.edge_time[order]
        dup = (s1[1:] == s1[:-1]) & (s2[1:] == s2[:-1]) & (s3[1:] == s3[:-1])
        if ev is not None:
            sv = ev[order]
            dup = dup & sv[1:] & sv[:-1]
        n_repeat_edges = dup.sum(dtype=torch.int32)

        if node_x_nids is not None:
            order = torch.argsort(node_x_time, stable=True)
            order = order[torch.argsort(node_x_nids[order], stable=True)]
            m1, m2 = node_x_nids[order], node_x_time[order]
            ndup = (m1[1:] == m1[:-1]) & (m2[1:] == m2[:-1])
            if node_x_valid is not None:
                mv = node_x_valid[order]
                ndup = ndup & mv[1:] & mv[:-1]
            n_repeat_nodes = ndup.sum(dtype=torch.int32)
        else:
            n_repeat_nodes = i32(0)

        self.add_batch_attribute(batch, "num_edge_events", n_edges)
        self.add_batch_attribute(batch, "num_node_events", n_nodes_ev)
        self.add_batch_attribute(batch, "num_unique_timestamps", n_unique_ts)
        self.add_batch_attribute(batch, "num_unique_nodes", n_unique_nodes)
        self.add_batch_attribute(batch, "avg_degree", avg_degree)
        self.add_batch_attribute(batch, "num_repeated_edge_events", n_repeat_edges)
        self.add_batch_attribute(batch, "num_repeated_node_events", n_repeat_nodes)
        return state, batch

    def __call__(self, dg: DGraph, batch: DGBatch) -> DGBatch:
        return self.apply(None, batch)[1]


@hook
class NodeAnalyticsHook(StatefulHook):
    """Per-tracked-node activity statistics plus batch novelty and density."""

    _cls_requires = {"edge_src", "edge_dst", "edge_time"}
    _cls_produces = {"node_stats", "node_macro_stats", "edge_stats"}

    #: Pair bitmaps up to this many bits key edge novelty exactly (8 MiB of
    #: 32-bit words).
    EXACT_BITMAP_MAX_BITS = 1 << 26

    def __init__(
        self,
        tracked_nodes,
        num_nodes: int,
        edge_hash_bits: int = 20,
        exact_edges: Optional[bool] = None,
        device: DeviceLike = None,
        id: Optional[str] = None,
    ) -> None:
        super().__init__(id=id)
        if num_nodes <= 0:
            raise ValueError("num_nodes must be positive")
        self.device = resolve_device(device)
        self.tracked_nodes = torch.as_tensor(
            np.unique(np.asarray(tracked_nodes)).astype(np.int64), device=self.device)
        self.num_nodes = num_nodes
        pair_space = (num_nodes + 1) * (num_nodes + 1)
        if exact_edges is None:
            exact_edges = pair_space <= self.EXACT_BITMAP_MAX_BITS
        if exact_edges and pair_space > _INT32_MAX:
            raise ValueError(f"exact_edges needs (num_nodes+1)^2 <= int32 max; got {pair_space}")
        self._exact = bool(exact_edges)
        self._hash_size = pair_space if self._exact else (1 << edge_hash_bits)

    def init_state(self, dg: Optional[DGraph] = None) -> Any:
        n = self.num_nodes + 1
        i32 = dict(dtype=torch.int32, device=self.device)
        return {
            "first_seen": torch.full((n,), -1, **i32),
            "last_seen": torch.full((n,), -1, **i32),
            "appearances": torch.zeros((n,), **i32),
            "seen_edges": torch.zeros(((self._hash_size + 31) // 32,), **i32),
        }

    def _edge_hash(self, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
        """Bitmap key of each (src, dst) pair, as int64, with JAX's int32 math."""
        src, dst = src.long(), dst.long()
        if self._exact:
            return src * (self.num_nodes + 1) + dst  # < 2^31, checked in __init__
        # Knuth multiplicative mix in wrapped int32, then |h| (|INT32_MIN|
        # stays INT32_MIN) and a floor modulo.
        h = _wrap_int32(src * -1640531527 + dst * 40503 - 2128831035).long()
        h = torch.where(h == _INT32_MIN, h, h.abs())
        return torch.remainder(h, self._hash_size)

    def apply(self, state: Any, batch: DGBatch) -> Tuple[Any, DGBatch]:
        n = self.num_nodes
        dev = batch.edge_src.device
        ev = batch.edge_valid
        valid = torch.ones(batch.edge_src.shape[0], dtype=torch.bool, device=dev) if ev is None \
            else ev
        src = torch.where(valid, batch.edge_src, n)
        dst = torch.where(valid, batch.edge_dst, n)
        t = batch.edge_time.int()

        endpoints = torch.cat([src, dst]).long()
        ep_t = torch.cat([t, t])
        ep_valid = torch.cat([valid, valid])

        deg = torch.zeros((n + 1,), dtype=torch.int32, device=dev).index_add_(
            0, endpoints, ep_valid.int())
        first_seen = state["first_seen"]
        was_seen = first_seen >= 0
        fs_batch = torch.full((n + 1,), _INT32_MAX, dtype=torch.int32, device=dev).scatter_reduce_(
            0, endpoints, torch.where(ep_valid, ep_t, _INT32_MAX), "amin")
        appeared = fs_batch < _INT32_MAX
        first_seen = torch.where(was_seen, first_seen, torch.where(appeared, fs_batch, -1))
        ls_batch = torch.full((n + 1,), -1, dtype=torch.int32, device=dev).scatter_reduce_(
            0, endpoints, torch.where(ep_valid, ep_t, -1), "amax")
        last_seen = torch.maximum(state["last_seen"], ls_batch)
        appearances = state["appearances"] + appeared.int()

        # Edge novelty: distinct unseen keys (sorted run starts), so a pair
        # repeated within the batch is new once.
        keys = self._edge_hash(src, dst)
        k_sorted, _ = torch.sort(torch.where(valid, keys, _INT32_MAX))
        run_start = torch.ones_like(k_sorted, dtype=torch.bool)
        run_start[1:] = k_sorted[1:] != k_sorted[:-1]
        k_safe = k_sorted.clamp(0, self._hash_size - 1)
        word_idx = k_safe >> 5
        bit = _wrap_int32(torch.ones_like(k_safe) << (k_safe & 31))
        words = state["seen_edges"]
        already_seen = (words[word_idx] & bit) != 0
        fresh = run_start & (k_sorted != _INT32_MAX) & ~already_seen
        new_edge_count = fresh.sum(dtype=torch.int32)
        # Every fresh key is a distinct unset bit: adding the bits sets them
        # (int32 addition wraps like the JAX uint32 words).
        seen_edges = words.clone().index_add_(0, word_idx, torch.where(fresh, bit, 0))
        n_edges = valid.sum(dtype=torch.int32)
        edge_novelty = new_edge_count.float() / n_edges.clamp_min(1).float()

        uniq_nodes = _masked_unique_count(endpoints.int(), ep_valid & (endpoints < n))
        pairs = (uniq_nodes * (uniq_nodes - 1)).float() / 2
        density = n_edges.float() / pairs.clamp_min(1)

        tn = self.tracked_nodes
        cur_t = torch.where(valid, t, 0).max()
        node_stats = {
            "degree": deg[tn],
            "activity": deg[tn],
            "lifetime": torch.where(first_seen[tn] >= 0, last_seen[tn] - first_seen[tn], 0),
            "time_since_seen": torch.where(last_seen[tn] >= 0, cur_t - last_seen[tn], -1),
            "appearances": appearances[tn],
        }
        new_in_batch = appeared[tn] & ~was_seen[tn]
        new_nodes = new_in_batch.sum(dtype=torch.int32)
        node_macro_stats = {
            "new_node_count": new_nodes,
            "node_novelty": new_nodes.float() / appeared[tn].sum(dtype=torch.int32)
            .clamp_min(1).float(),
        }
        edge_stats = {
            "edge_novelty": edge_novelty,
            "edge_density": density,
            "new_edge_count": new_edge_count,
            "novelty_is_exact": torch.full((), self._exact, dtype=torch.bool, device=dev),
            "seen_bitmap_load": _popcount(seen_edges).sum().int().float()
            / float(self._hash_size),
        }
        self.add_batch_attribute(batch, "node_stats", node_stats)
        self.add_batch_attribute(batch, "node_macro_stats", node_macro_stats)
        self.add_batch_attribute(batch, "edge_stats", edge_stats)
        first_seen[n] = -1
        last_seen[n] = -1
        appearances[n] = 0
        new_state = {"first_seen": first_seen, "last_seen": last_seen,
                     "appearances": appearances, "seen_edges": seen_edges}
        return new_state, batch
