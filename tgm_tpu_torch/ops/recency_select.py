"""Recency window select: kernel K1 and its plain PyTorch version.

Port of ``tgm_tpu/ops/pallas/recency_select.py::recency_window_select_eid``
and ``recency_window_select_eid_lanes``: for each seed's pre-gathered B-slot
ring row, the K most recent (id, time, edge id) strictly before the seed's
query time, oldest to newest, right-aligned, filled with PAD / 0 / -1.

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/recency_select.cu``; on a CPU tensor it runs the plain version. The
plain version is the JAX package's jnp algorithm (``hooks/neighbors.py``:
unroll the ring, find the last valid slot, gather the K-window ending there),
not the kernel's rank walk, so holding one against the other tests something.
The two agree on rows whose times do not decrease from oldest to newest
slot, which is what a chronological stream's pushes leave.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..constants import PADDED_NODE_ID
from . import _native

MAX_BUFFER_SLOTS = 64

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def recency_window_select_eid_plain(
    ids: torch.Tensor,
    times: torch.Tensor,
    eids: torch.Tensor,
    write_pos: torch.Tensor,
    query_times: torch.Tensor,
    k: int,
) -> Triple:
    """Plain PyTorch version of K1 (the jnp path of ``recency_eid_query``)."""
    S, B = ids.shape
    dev = ids.device
    # Unrolled order: oldest ... newest (newest at column B-1). torch.remainder
    # is the floor modulo of jnp's %; write_pos may be any non-negative int.
    cand_idx = torch.remainder(
        write_pos.long()[:, None] - torch.arange(B, 0, -1, device=dev)[None, :], B
    )
    cand_times = times.gather(1, cand_idx)
    cand_ids = ids.gather(1, cand_idx)
    tmask = (cand_times < query_times[:, None]) & (cand_ids != PADDED_NODE_ID)

    pos = torch.arange(B, device=dev)[None, :]
    last_valid = torch.where(tmask.any(dim=1), (tmask * pos).amax(dim=1), -1)

    offset = torch.arange(k - 1, -1, -1, device=dev)[None, :]
    gather_pos = torch.clamp_min(last_valid[:, None] - offset, -1)
    out_idx = torch.where(
        gather_pos >= 0, cand_idx.gather(1, gather_pos.clamp_min(0)), -1
    )
    valid = out_idx >= 0
    safe = out_idx.clamp_min(0)
    out_ids = torch.where(valid, ids.gather(1, safe), PADDED_NODE_ID)
    out_times = torch.where(valid, times.gather(1, safe), 0)
    out_eids = torch.where(valid, eids.gather(1, safe), -1)
    return out_ids.int(), out_times.int(), out_eids.int()


def _check(ids, times, eids, write_pos, query_times, k) -> None:
    S, B = ids.shape
    for name, t in (("times", times), ("eids", eids)):
        if t.shape != (S, B):
            raise ValueError(f"{name} must have shape {(S, B)}, got {tuple(t.shape)}")
    for name, t in (("write_pos", write_pos), ("query_times", query_times)):
        if t.shape != (S,):
            raise ValueError(f"{name} must have shape {(S,)}, got {tuple(t.shape)}")
    for name, t in (("ids", ids), ("times", times), ("eids", eids),
                    ("write_pos", write_pos), ("query_times", query_times)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != ids.device:
            raise ValueError(f"{name} is on {t.device}, ids on {ids.device}")
    if not 1 <= k <= B:
        raise ValueError(f"k must be in [1, B={B}], got {k}")
    if B > MAX_BUFFER_SLOTS:
        raise ValueError(f"the kernel takes at most {MAX_BUFFER_SLOTS} buffer slots, got {B}")


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
    _check(ids, times, eids, write_pos, query_times, k)
    if ids.device.type == "cpu":
        return recency_window_select_eid_plain(ids, times, eids, write_pos, query_times, k)
    if ids.device.type != "cuda":
        raise ValueError(f"unsupported device {ids.device}")
    S, B = ids.shape
    outs = tuple(torch.empty((S, k), dtype=torch.int32, device=ids.device) for _ in range(3))
    if S == 0:
        return outs
    ins = [t.contiguous() for t in (ids, times, eids, write_pos, query_times)]
    _native.launch("recency_select", "recency_window_select_eid", [*ins, *outs], [S, B, k])
    recency_window_select_eid.launches += 1
    return outs


recency_window_select_eid.launches = 0
