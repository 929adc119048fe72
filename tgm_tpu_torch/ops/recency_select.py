"""Recency window select: kernels K1 and K4 and their plain PyTorch versions.

Port of ``tgm_tpu/ops/pallas/recency_select.py``:

* ``recency_window_select_eid`` (K1) replaces ``recency_window_select_eid``
  and ``recency_window_select_eid_lanes``: for each seed's pre-gathered
  B-slot ring row, the K most recent (id, time, edge id) strictly before the
  seed's query time, oldest to newest, right-aligned, filled with PAD / 0 / -1.
* ``recency_eid_select`` launches the same kernel K1 on the ring state
  itself: it reads each seed's row in place (invalid seeds read the dump row)
  and, given the static edge-feature table (fp32 or bf16), writes the
  selected edges' feature rows too, what ``gather_edge_feats`` would give.
  This is the hook's eid-layout query: one launch, no gathered rows.
* ``recency_window_select`` (K4) replaces ``recency_window_select``: the same
  select carrying an (S, B, D) fp32 feature payload, copied exactly, filled
  with PAD / 0 / 0.0.
* ``recency_feats_select`` launches the same kernel K4 on the feature
  layout's ring state itself: it reads each seed's ids, times, write
  position and selected feature rows in place (invalid seeds read the dump
  row). This is the hook's feature-layout query: one launch, no gathered
  rows.

On a CUDA tensor a wrapper launches its hand-written kernel in
``csrc/recency_select.cu``; on a CPU tensor it runs the plain version. Both
compute the Pallas kernels' rank rule: slot j has age ``(wp - 1 - j) mod B``
(0 = newest); it is valid iff ``time < query_time`` and ``id != PAD``; its
rank is the number of valid slots more recent than it; it is selected iff
its rank is below K and goes to column ``K - 1 - rank``. The plain versions
compute every rank at once as an (S, B, B) compare-and-sum and scatter the
selected slots; the kernels ballot each seed's slots, so holding one against
the other tests two algorithms. On rows whose times do not decrease from
oldest to newest slot, which is all a chronological stream leaves, the rule
equals the JAX package's jnp path.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..constants import PADDED_NODE_ID
from . import _native

MAX_BUFFER_SLOTS = 64
# The edge tables K1 copies rows of (as bytes: 4 or 2 a value).
FEATURE_DTYPES = (torch.float32, torch.bfloat16)

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
Quad = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def seed_rows(seeds: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """State row of each seed: the seed itself, or the dump row ``num_nodes``
    for an invalid seed (< 0 or >= num_nodes)."""
    seed_ok = (seeds >= 0) & (seeds < num_nodes)
    return torch.where(seed_ok, seeds, num_nodes).long()


def gather_edge_feats(edge_x: Optional[torch.Tensor], eids: torch.Tensor) -> torch.Tensor:
    """Features of selected edges; eid -1 (padding) yields zero rows."""
    if edge_x is None:
        return torch.zeros(eids.shape + (0,), dtype=torch.float32, device=eids.device)
    valid = eids >= 0
    rows = eids.clamp(0, edge_x.shape[0] - 1).long()
    return torch.where(valid[..., None], edge_x[rows], 0.0)


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


def _check(ids, times, payload, write_pos, query_times, k, payload_dtype, seeds=None) -> None:
    """Checks (N, B) rows with their write positions, and one query time per
    seed: per row without ``seeds``, per entry of ``seeds`` with them."""
    N, B = ids.shape
    S = N if seeds is None else seeds.shape[0]
    if times.shape != (N, B):
        raise ValueError(f"times must have shape {(N, B)}, got {tuple(times.shape)}")
    if payload.shape[:2] != (N, B):
        raise ValueError(f"the payload must start with shape {(N, B)}, got {tuple(payload.shape)}")
    shaped = [("write_pos", write_pos, (N,)), ("query_times", query_times, (S,))]
    if seeds is not None:
        shaped.append(("seeds", seeds, (S,)))
    for name, t, shape in shaped:
        if t.shape != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    typed = [("ids", ids, torch.int32), ("times", times, torch.int32),
             ("payload", payload, payload_dtype), ("write_pos", write_pos, torch.int32),
             ("query_times", query_times, torch.int32)]
    if seeds is not None:
        typed.append(("seeds", seeds, torch.int32))
    for name, t, dtype in typed:
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


def _launch_k1(rows: Sequence[torch.Tensor], seeds: Optional[torch.Tensor],
               query_times: torch.Tensor, edge_x: Optional[torch.Tensor], outs: Triple,
               out_feats: Optional[torch.Tensor], k: int) -> None:
    """Launch K1 over (N1, B) rows (ids, times, eids, write_pos): row
    ``seeds[s]`` for seed s (the dump row N1 - 1 if invalid), or row s
    without seeds; features only with both ``edge_x`` and ``out_feats``,
    copied as bytes (a row is D elements of ``edge_x.element_size()``)."""
    N1, B = rows[0].shape
    E_all, D = (0, 0) if edge_x is None else edge_x.shape
    esize = 4 if edge_x is None else edge_x.element_size()
    ins = [None if t is None else t.contiguous()
           for t in (*rows, seeds, query_times, edge_x)]
    _native.launch("recency_select", "recency_eid_select", [*ins, *outs, out_feats],
                   [query_times.shape[0], N1, B, k, E_all, D * esize])


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
    S = ids.shape[0]
    outs = tuple(torch.empty((S, k), dtype=torch.int32, device=ids.device) for _ in range(3))
    if S == 0:
        return outs
    _launch_k1((ids, times, eids, write_pos), None, query_times, None, outs, None, k)
    recency_window_select_eid.launches += 1
    return outs


recency_window_select_eid.launches = 0


def recency_eid_select_plain(state: Sequence[torch.Tensor], seeds: torch.Tensor,
                             seed_times: torch.Tensor, k: int,
                             edge_x: Optional[torch.Tensor] = None) -> Quad:
    """Plain version of ``recency_eid_select``: gather each seed's rows, K1's
    plain select, then ``gather_edge_feats``."""
    nbr_ids, nbr_times, nbr_eids, write_pos = state
    rows = seed_rows(seeds, nbr_ids.shape[0] - 1)
    ids, times, eids = recency_window_select_eid_plain(
        nbr_ids[rows], nbr_times[rows], nbr_eids[rows], write_pos[rows], seed_times, k)
    return ids, times, eids, gather_edge_feats(edge_x, eids)


def recency_eid_select(
    state: Sequence[torch.Tensor],  # (N1, B) int32 ids, times, edge ids; (N1,) int32 write_pos
    seeds: torch.Tensor,  # (S,) int32 node ids; invalid ones read the dump row N1 - 1
    seed_times: torch.Tensor,  # (S,) int32
    k: int,
    edge_x: Optional[torch.Tensor] = None,  # (E_all, D) float32 or bfloat16 edge features
) -> Quad:
    """K most recent (id, time, edge id, features) per seed before its time.

    Reads the eid-layout ring state in place: no per-seed rows are gathered.
    Returns (S, K) int32 ids, times and edge ids, filled with PAD / 0 / -1,
    and (S, K, D) features of the selected edges in the table's dtype (zero
    rows for edge id -1; fp32 (S, K, 0) without ``edge_x``), equal to
    ``gather_edge_feats(edge_x, eids)`` bit for bit. One launch of kernel K1
    on CUDA tensors, the plain version on CPU tensors;
    ``recency_eid_select.launches`` counts kernel launches.
    """
    nbr_ids, nbr_times, nbr_eids, write_pos = state
    _check(nbr_ids, nbr_times, nbr_eids, write_pos, seed_times, k, torch.int32, seeds=seeds)
    dev = nbr_ids.device
    if edge_x is not None and (edge_x.dim() != 2 or edge_x.shape[0] == 0
                               or edge_x.dtype not in FEATURE_DTYPES or edge_x.device != dev):
        raise ValueError(f"edge_x must be a float32 or bfloat16 table of at least one row on "
                         f"{dev}, got {edge_x.dtype} {tuple(edge_x.shape)} on {edge_x.device}")
    if dev.type == "cpu":
        return recency_eid_select_plain(state, seeds, seed_times, k, edge_x)
    S = seeds.shape[0]
    D = 0 if edge_x is None else edge_x.shape[1]
    outs = tuple(torch.empty((S, k), dtype=torch.int32, device=dev) for _ in range(3))
    feats = torch.empty((S, k, D), dtype=torch.float32 if edge_x is None else edge_x.dtype,
                        device=dev)
    if S == 0:
        return (*outs, feats)
    with_feats = D > 0  # a zero-width table has nothing to copy
    _launch_k1(state, seeds, seed_times, edge_x if with_feats else None, outs,
               feats if with_feats else None, k)
    recency_eid_select.launches += 1
    return (*outs, feats)


recency_eid_select.launches = 0


def recency_feats_select_plain(state: Sequence[torch.Tensor], seeds: torch.Tensor,
                               seed_times: torch.Tensor, k: int) -> Triple:
    """Plain version of ``recency_feats_select``: gather each seed's rows,
    then K4's plain select."""
    nbr_ids, nbr_times, nbr_feats, write_pos = state
    rows = seed_rows(seeds, nbr_ids.shape[0] - 1)
    return recency_window_select_plain(nbr_ids[rows], nbr_times[rows], nbr_feats[rows],
                                       write_pos[rows], seed_times, k)


def _launch_k4(rows: Sequence[torch.Tensor], seeds: Optional[torch.Tensor],
               query_times: torch.Tensor, k: int) -> Triple:
    """Launch K4 over (N1, B) rows (ids, times, (N1, B, D) features,
    write_pos): row ``seeds[s]`` for seed s (the dump row N1 - 1 if
    invalid), or row s without seeds. Returns the (S, K) ids and times and
    the (S, K, D) features."""
    N1, B, D = rows[2].shape
    S = query_times.shape[0]
    dev = query_times.device
    outs = (torch.empty((S, k), dtype=torch.int32, device=dev),
            torch.empty((S, k), dtype=torch.int32, device=dev),
            torch.empty((S, k, D), dtype=torch.float32, device=dev))
    if S == 0:
        return outs
    ins = [None if t is None else t.contiguous() for t in (*rows, seeds, query_times)]
    _native.launch("recency_select", "recency_feats_select", [*ins, *outs], [S, N1, B, k, D])
    return outs


def recency_feats_select(
    state: Sequence[torch.Tensor],  # (N1, B) int32 ids, times; (N1, B, D) fp32; (N1,) wp
    seeds: torch.Tensor,  # (S,) int32 node ids; invalid ones read the dump row N1 - 1
    seed_times: torch.Tensor,  # (S,) int32
    k: int,
) -> Triple:
    """K most recent (id, time, features) per seed before its time.

    Reads the feature-layout ring state in place: no per-seed rows are
    gathered. Returns (S, K) int32 ids and times, filled with PAD / 0, and
    (S, K, D) fp32 features copied bit for bit (zero rows where empty; (S,
    K, 0) for D = 0). One launch of kernel K4 on CUDA tensors, the plain
    version on CPU tensors; ``recency_feats_select.launches`` counts kernel
    launches.
    """
    nbr_ids, nbr_times, nbr_feats, write_pos = state
    if nbr_feats.dim() != 3:
        raise ValueError(f"nbr_feats must be (N1, B, D), got shape {tuple(nbr_feats.shape)}")
    _check(nbr_ids, nbr_times, nbr_feats, write_pos, seed_times, k, torch.float32, seeds=seeds)
    if nbr_ids.device.type == "cpu":
        return recency_feats_select_plain(state, seeds, seed_times, k)
    outs = _launch_k4(state, seeds, seed_times, k)
    if seeds.shape[0]:
        recency_feats_select.launches += 1
    return outs


recency_feats_select.launches = 0


def recency_window_select(
    ids: torch.Tensor,  # (S, B) int32 buffer rows (pre-gathered per seed)
    times: torch.Tensor,  # (S, B) int32
    feats: torch.Tensor,  # (S, B, D) float32 feature payload
    write_pos: torch.Tensor,  # (S,) int32
    query_times: torch.Tensor,  # (S,) int32
    k: int,
) -> Triple:
    """K most recent (id, time, features) per seed before its query time.

    The Pallas function's contract, on rows the caller gathered per seed:
    (S, K) ids and times and (S, K, D) features, filled with PAD / 0 / 0.0;
    the features are copied bit for bit. Kernel K4 (the kernel of
    ``recency_feats_select``, row s for seed s) on CUDA tensors, the plain
    version on CPU tensors; ``recency_window_select.launches`` counts kernel
    launches.
    """
    if feats.dim() != 3:
        raise ValueError(f"feats must be (S, B, D), got shape {tuple(feats.shape)}")
    _check(ids, times, feats, write_pos, query_times, k, torch.float32)
    if ids.device.type == "cpu":
        return recency_window_select_plain(ids, times, feats, write_pos, query_times, k)
    outs = _launch_k4((ids, times, feats, write_pos), None, query_times, k)
    if ids.shape[0]:
        recency_window_select.launches += 1
    return outs


recency_window_select.launches = 0
