"""Recency window select: kernels K1 and K4 and their plain PyTorch versions.

Port of ``tgm_tpu/ops/pallas/recency_select.py``:

* ``recency_window_select_eid`` (K1) replaces ``recency_window_select_eid``
  and ``recency_window_select_eid_lanes``: for each seed's pre-gathered
  B-slot ring row, the K most recent (id, time, edge id) strictly before the
  seed's query time, oldest to newest, right-aligned, filled with PAD / 0 / -1.
* ``recency_window_select`` (K4) replaces ``recency_window_select``: the same
  select carrying an (S, B, D) fp32 feature payload, copied exactly, filled
  with PAD / 0 / 0.0.

On a CUDA tensor a wrapper launches its hand-written kernel in
``csrc/recency_select.cu``; on a CPU tensor it runs the plain version. Both
compute the Pallas kernels' rank rule: slot j has age ``(wp - 1 - j) mod B``
(0 = newest); it is valid iff ``time < query_time`` and ``id != PAD``; its
rank is the number of valid slots more recent than it; it is selected iff
its rank is below K and goes to column ``K - 1 - rank``. The plain versions
compute every rank at once as an (S, B, B) compare-and-sum and scatter the
selected slots; the kernels walk (K1) or ballot (K4) each seed's slots, so
holding one against the other tests two algorithms. On rows whose times do
not decrease from oldest to newest slot, which is all a chronological
stream leaves, the rule equals the JAX package's jnp path.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..constants import PADDED_NODE_ID
from . import _native

MAX_BUFFER_SLOTS = 64

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _rank_columns(ids: torch.Tensor, times: torch.Tensor, write_pos: torch.Tensor,
                  query_times: torch.Tensor, k: int) -> torch.Tensor:
    """(S, B) output column of each slot under the rank rule; K where unselected."""
    B = ids.shape[1]
    slot = torch.arange(B, device=ids.device)
    # torch.remainder is the floor modulo of jnp's %: write_pos grows without bound.
    age = torch.remainder(write_pos.long()[:, None] - 1 - slot[None, :], B)
    valid = (times < query_times[:, None]) & (ids != PADDED_NODE_ID)
    more_recent = (age[:, None, :] < age[:, :, None]) & valid[:, None, :]  # (S, B, B)
    rank = more_recent.sum(dim=2)
    return torch.where(valid & (rank < k), k - 1 - rank, k)


def _select(values: torch.Tensor, cols: torch.Tensor, k: int, fill) -> torch.Tensor:
    """Scatter each slot's value to its column; column K collects the unselected."""
    S = values.shape[0]
    out = torch.full((S, k + 1) + tuple(values.shape[2:]), fill, dtype=values.dtype,
                     device=values.device)
    index = cols.reshape(cols.shape + (1,) * (values.dim() - 2)).expand_as(values)
    return out.scatter_(1, index, values)[:, :k]


def recency_window_select_eid_plain(
    ids: torch.Tensor,
    times: torch.Tensor,
    eids: torch.Tensor,
    write_pos: torch.Tensor,
    query_times: torch.Tensor,
    k: int,
) -> Triple:
    """Plain PyTorch version of K1 (the rank rule of the Pallas kernels)."""
    cols = _rank_columns(ids, times, write_pos, query_times, k)
    return (_select(ids, cols, k, PADDED_NODE_ID), _select(times, cols, k, 0),
            _select(eids, cols, k, -1))


def recency_window_select_plain(
    ids: torch.Tensor,
    times: torch.Tensor,
    feats: torch.Tensor,
    write_pos: torch.Tensor,
    query_times: torch.Tensor,
    k: int,
) -> Triple:
    """Plain PyTorch version of K4: K1's select plus an exact copy of the features."""
    cols = _rank_columns(ids, times, write_pos, query_times, k)
    return (_select(ids, cols, k, PADDED_NODE_ID), _select(times, cols, k, 0),
            _select(feats, cols, k, 0.0))


def _check(ids, times, payload, write_pos, query_times, k, payload_dtype) -> None:
    S, B = ids.shape
    if times.shape != (S, B):
        raise ValueError(f"times must have shape {(S, B)}, got {tuple(times.shape)}")
    if payload.shape[:2] != (S, B):
        raise ValueError(f"the payload must start with shape {(S, B)}, got {tuple(payload.shape)}")
    for name, t in (("write_pos", write_pos), ("query_times", query_times)):
        if t.shape != (S,):
            raise ValueError(f"{name} must have shape {(S,)}, got {tuple(t.shape)}")
    for name, t, dtype in (("ids", ids, torch.int32), ("times", times, torch.int32),
                           ("payload", payload, payload_dtype),
                           ("write_pos", write_pos, torch.int32),
                           ("query_times", query_times, torch.int32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != ids.device:
            raise ValueError(f"{name} is on {t.device}, ids on {ids.device}")
    if not 1 <= k <= B:
        raise ValueError(f"k must be in [1, B={B}], got {k}")
    if B > MAX_BUFFER_SLOTS:
        raise ValueError(f"the kernel takes at most {MAX_BUFFER_SLOTS} buffer slots, got {B}")
    if ids.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {ids.device}")


def recency_window_select_eid(
    ids: torch.Tensor,  # (S, B) int32 buffer rows (pre-gathered per seed)
    times: torch.Tensor,  # (S, B) int32
    eids: torch.Tensor,  # (S, B) int32 edge ids
    write_pos: torch.Tensor,  # (S,) int32
    query_times: torch.Tensor,  # (S,) int32
    k: int,
) -> Triple:
    """K most recent (id, time, edge id) per seed before its query time.

    Kernel K1 on CUDA tensors, the plain version on CPU tensors. The
    wrapper's ``launches`` attribute counts kernel launches.
    """
    _check(ids, times, eids, write_pos, query_times, k, torch.int32)
    if ids.device.type == "cpu":
        return recency_window_select_eid_plain(ids, times, eids, write_pos, query_times, k)
    S, B = ids.shape
    outs = tuple(torch.empty((S, k), dtype=torch.int32, device=ids.device) for _ in range(3))
    if S == 0:
        return outs
    ins = [t.contiguous() for t in (ids, times, eids, write_pos, query_times)]
    _native.launch("recency_select", "recency_window_select_eid", [*ins, *outs], [S, B, k])
    recency_window_select_eid.launches += 1
    return outs


recency_window_select_eid.launches = 0


def recency_window_select(
    ids: torch.Tensor,  # (S, B) int32 buffer rows (pre-gathered per seed)
    times: torch.Tensor,  # (S, B) int32
    feats: torch.Tensor,  # (S, B, D) float32 feature payload
    write_pos: torch.Tensor,  # (S,) int32
    query_times: torch.Tensor,  # (S,) int32
    k: int,
) -> Triple:
    """K most recent (id, time, features) per seed before its query time.

    Returns (S, K) ids and times and (S, K, D) features, filled with PAD / 0 /
    0.0; the features are copied bit for bit. Kernel K4 on CUDA tensors, the
    plain version on CPU tensors; ``recency_window_select.launches`` counts
    kernel launches.
    """
    if feats.dim() != 3:
        raise ValueError(f"feats must be (S, B, D), got shape {tuple(feats.shape)}")
    _check(ids, times, feats, write_pos, query_times, k, torch.float32)
    if ids.device.type == "cpu":
        return recency_window_select_plain(ids, times, feats, write_pos, query_times, k)
    S, B = ids.shape
    D = feats.shape[2]
    dev = ids.device
    outs = (torch.empty((S, k), dtype=torch.int32, device=dev),
            torch.empty((S, k), dtype=torch.int32, device=dev),
            torch.empty((S, k, D), dtype=torch.float32, device=dev))
    if S == 0:
        return outs
    ins = [t.contiguous() for t in (ids, times, feats, write_pos, query_times)]
    _native.launch("recency_select", "recency_window_select", [*ins, *outs], [S, B, k, D])
    recency_window_select.launches += 1
    return outs


recency_window_select.launches = 0
