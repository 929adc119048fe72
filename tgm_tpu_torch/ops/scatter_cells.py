"""In-place state writes of the serving paths: the recency push, the TGN
message-store commit, kernels K2 and K3, and their plain versions.

Port of ``tgm_tpu/ops/pallas/scatter_cells.py`` and of the code that calls
it: the push (``tgm_tpu/hooks/neighbors.py::_recency_push`` with its dense
plan) and the TGN store (``tgm_tpu/nn/encoder/tgn.py::tgn_store_messages``).
Where the JAX functions return new arrays, these write into the tensors they
are given and return them: the callers' state tensors are updated in place.

* ``recency_push``: one ring-buffer push of a batch of events, planned and
  written on the card (two launches of ``csrc/scatter_cells.cu``), for both
  recency state layouts. This is what the hook runs.
* ``tgn_store_commit``: the whole TGN LastAggregator message store of a
  batch, planned and written on the card in one launch. This is what
  ``tgn_store_messages`` runs.
* ``scatter_cells`` (K2): the Pallas function's own contract, one int32
  plane's cell scatter. Off the serving paths since the push kernel.
* ``tgn_store_scatter_1d`` (K3): the Pallas function's own contract, the
  four int32 TGN message-store writes. Off the serving paths since the
  store-commit kernel.

On CUDA tensors the wrappers launch the hand-written kernels; on CPU tensors
they run the plain versions. Both skip targets at the last row (the dump row)
and beyond and leave every skipped row as it was.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _native
from .segment import segment_max


def _require_int32(device: torch.device, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")


def put_live(x: torch.Tensor, index: Tuple[torch.Tensor, ...], live: torch.Tensor,
              vals: torch.Tensor) -> None:
    """``x[index] = vals`` where ``live``; other writes go to the last row,
    which is restored afterwards (the JAX path's write-then-reset)."""
    last = x.shape[0] - 1
    saved = x[last].clone()
    idx = (torch.where(live, index[0], last).long(),) + tuple(
        torch.where(live, i, 0).long() for i in index[1:]
    )
    x.index_put_(idx, vals)
    x[last] = saved


def push_plan_dense(
    B: int,
    write_pos: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    time: torch.Tensor,
    valid: Optional[torch.Tensor],
    directed: bool,
    num_nodes: int,
):
    """Sort-free write plan of a ring-buffer push (the JAX ``_push_plan_dense``).

    Each event's within-node recency rank ``r`` is the number of events of the
    same node strictly later in (time, position) order, an (E, E)
    compare-and-sum. Events with ``r < B`` are kept; write columns follow the
    (write_pos + offset-from-start) % B layout of the sorted plan, so the
    buffers come out identical. Payloads scatter in the original event order.

    Returns ``(rows, cols, nbrs, t, rows_last, wp_last)``: int32 targets
    (dropped events aim at the dump row), the neighbour and time of each
    event, and each node's post-push write position set at its final event.
    """
    if valid is None:
        valid = torch.ones(src.shape[0], dtype=torch.bool, device=src.device)
    if directed:
        nodes, nbrs, t, v = src, dst, time, valid
    else:
        nodes = torch.cat([src, dst])
        nbrs = torch.cat([dst, src])
        t = torch.cat([time, time])
        v = torch.cat([valid, valid])

    nodes = torch.where(v, nodes, num_nodes)
    E2 = nodes.shape[0]
    idx = torch.arange(E2, device=nodes.device)

    same = nodes[:, None] == nodes[None, :]  # (E2, E2)
    # Stable (time, concat-position) order, as a stable argsort on time.
    later = (t[None, :] > t[:, None]) | ((t[None, :] == t[:, None]) & (idx[None, :] > idx[:, None]))
    r = (same & later).sum(dim=1)  # strictly-later same-node events
    earlier = (same & ~later).sum(dim=1) - 1  # excludes self
    cnt = earlier + r + 1

    keep = r < B
    kept_offset = torch.clamp_min(earlier - torch.clamp_min(cnt - B, 0), 0)
    wp_nodes = write_pos[nodes.long()].long()
    write_idx = torch.remainder(wp_nodes + kept_offset, B)
    rows = torch.where(keep, nodes, num_nodes).int()
    cols = torch.where(keep, write_idx, 0).int()

    rows_last = torch.where(r == 0, nodes, num_nodes).int()
    wp_last = (wp_nodes + torch.clamp_max(cnt, B)).int()
    return rows, cols, nbrs.int(), t.int(), rows_last, wp_last


def recency_push_plain(nbr_ids, nbr_times, payload_buf, write_pos, src, dst, time, payload,
                       valid, directed: bool):
    """Plain version of ``recency_push``: the dense plan, then masked
    ``index_put_`` writes of the three planes and of ``write_pos``."""
    N1, B = nbr_ids.shape
    num_nodes = N1 - 1
    rows, cols, s_nbrs, s_t, rows_last, wp_last = push_plan_dense(
        B, write_pos, src, dst, time, valid, directed, num_nodes
    )
    s_f = payload if directed else torch.cat([payload, payload])
    # The plan is built: write_pos may change now. Each node's final event
    # carries its new write position; every other event aims at the dump row.
    put_live(write_pos, (rows_last,), (rows_last >= 0) & (rows_last < num_nodes), wp_last)
    live = (rows >= 0) & (rows < num_nodes)
    for buf, vals in ((nbr_ids, s_nbrs), (nbr_times, s_t), (payload_buf, s_f.to(payload_buf.dtype))):
        put_live(buf, (rows, cols), live, vals)
    return nbr_ids, nbr_times, payload_buf, write_pos


def recency_push(
    nbr_ids: torch.Tensor,  # (N1, B) int32
    nbr_times: torch.Tensor,  # (N1, B) int32
    payload_buf: torch.Tensor,  # (N1, B) int32 edge ids or (N1, B, D) float32 features
    write_pos: torch.Tensor,  # (N1,) int32
    src: torch.Tensor,  # (E,) int32
    dst: torch.Tensor,  # (E,) int32
    time: torch.Tensor,  # (E,) int32
    payload: torch.Tensor,  # (E,) int32 or (E, D) float32, as payload_buf
    valid: Optional[torch.Tensor],  # (E,) bool, or None for all valid
    directed: bool,
):
    """Push a batch of edge events into recency ring buffers, in place.

    Event i is (src[i], dst[i]); an undirected push also pushes (dst[i],
    src[i]). Each node keeps its last B events in (time, position) order,
    exactly as the JAX push does; invalid events and rows at N1 - 1 and
    beyond write nothing, so the dump row is never touched. On CUDA tensors
    one call launches two kernels (plan and write, then the write positions)
    and ``recency_push.launches`` counts both; on CPU tensors it runs the
    plain version. Returns the four state tensors.
    """
    if nbr_ids.dim() != 2 or payload_buf.dim() not in (2, 3):
        raise ValueError(f"nbr_ids must be (N1, B) and payload_buf (N1, B) or (N1, B, D), got "
                         f"{tuple(nbr_ids.shape)} and {tuple(payload_buf.shape)}")
    N1, B = nbr_ids.shape
    E = src.shape[0]
    feats = payload_buf.dim() == 3
    pay_dtype = torch.float32 if feats else torch.int32
    row = tuple(payload_buf.shape[2:])  # (D,) or ()
    shaped = [("nbr_times", nbr_times, (N1, B)), ("payload_buf", payload_buf, (N1, B) + row),
              ("write_pos", write_pos, (N1,)), ("src", src, (E,)), ("dst", dst, (E,)),
              ("time", time, (E,)), ("payload", payload, (E,) + row)]
    if valid is not None:
        shaped.append(("valid", valid, (E,)))
    for name, t, shape in shaped:
        if t.shape != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    _require_int32(nbr_ids.device, nbr_ids=nbr_ids, nbr_times=nbr_times, write_pos=write_pos,
                   src=src, dst=dst, time=time)
    for name, t, dtype in (("payload_buf", payload_buf, pay_dtype),
                           ("payload", payload, pay_dtype),
                           ("valid", valid, torch.bool)):
        if t is not None and (t.dtype != dtype or t.device != nbr_ids.device):
            raise TypeError(f"{name} must be {dtype} on {nbr_ids.device}, got {t.dtype} on "
                            f"{t.device}")
    args = (nbr_ids, nbr_times, payload_buf, write_pos, src, dst, time, payload, valid, directed)
    if nbr_ids.device.type == "cpu":
        return recency_push_plain(*args)
    if nbr_ids.device.type != "cuda":
        raise ValueError(f"unsupported device {nbr_ids.device}")
    if not all(t.is_contiguous() for t in (nbr_ids, nbr_times, payload_buf, write_pos)):
        raise ValueError("the state must be contiguous: the kernels write it in place")
    if E == 0:
        return nbr_ids, nbr_times, payload_buf, write_pos
    E2 = E if directed else 2 * E
    stash = torch.empty(2 * E2, dtype=torch.int32, device=nbr_ids.device)
    ins = [None if t is None else t.contiguous() for t in (src, dst, time, valid, payload)]
    D = payload_buf.shape[2] if feats else 0
    _native.launch("scatter_cells", "recency_push",
                   [nbr_ids, nbr_times, payload_buf, write_pos, *ins, stash],
                   [E, int(directed), N1, B, int(feats), D])
    recency_push.launches += 2
    return nbr_ids, nbr_times, payload_buf, write_pos


recency_push.launches = 0


def scatter_cells_plain(buf: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                        vals: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: masked ``index_put_`` plus a dump-row restore."""
    N1, B = buf.shape
    live = (rows >= 0) & (rows <= N1 - 2) & (cols >= 0) & (cols < B)
    put_live(buf, (rows, cols), live, vals)
    return buf


def scatter_cells(buf: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """``buf[rows[i], cols[i]] = vals[i]`` in place on an (N1, B) int32 buffer.

    Targets with rows > N1 - 2 (the dump row and beyond) are skipped. Each
    live target must be written at most once (the recency push plan
    guarantees it). Kernel K2 on CUDA tensors; ``scatter_cells.launches``
    counts its launches.
    """
    if buf.dim() != 2:
        raise ValueError(f"buf must be 2-D, got shape {tuple(buf.shape)}")
    E = rows.shape[0]
    if rows.shape != (E,) or cols.shape != (E,) or vals.shape != (E,):
        raise ValueError("rows, cols and vals must be 1-D of one length")
    _require_int32(buf.device, buf=buf, rows=rows, cols=cols, vals=vals)
    if buf.device.type == "cpu":
        return scatter_cells_plain(buf, rows, cols, vals)
    if buf.device.type != "cuda":
        raise ValueError(f"unsupported device {buf.device}")
    if not buf.is_contiguous():
        raise ValueError("buf must be contiguous: the kernel writes it in place")
    if E == 0:
        return buf
    N1, B = buf.shape
    rows, cols, vals = (t.contiguous() for t in (rows, cols, vals))
    _native.launch("scatter_cells", "scatter_cells", [buf, rows, cols, vals], [E, N1, B])
    scatter_cells.launches += 1
    return buf


scatter_cells.launches = 0


def tgn_store_scatter_1d_plain(s_other, s_t, d_other, d_t, rows_s, vals_s_other, vals_s_t,
                               rows_d, vals_d_other, vals_d_t, last_live_row: int):
    """Plain version of K3: four masked ``index_put_`` calls."""
    live_s = (rows_s >= 0) & (rows_s <= last_live_row)
    live_d = (rows_d >= 0) & (rows_d <= last_live_row)
    put_live(s_other, (rows_s,), live_s, vals_s_other)
    put_live(s_t, (rows_s,), live_s, vals_s_t)
    put_live(d_other, (rows_d,), live_d, vals_d_other)
    put_live(d_t, (rows_d,), live_d, vals_d_t)
    return s_other, s_t, d_other, d_t


def tgn_store_scatter_1d(s_other, s_t, d_other, d_t, rows_s, vals_s_other, vals_s_t,
                         rows_d, vals_d_other, vals_d_t, last_live_row: int):
    """In place: ``s_other/s_t[rows_s] = vals`` and ``d_other/d_t[rows_d] = vals``.

    Rows past ``last_live_row`` (the dump row and beyond) are skipped; each
    live row is written at most once per role. One launch of kernel K3 does
    all four stores on CUDA tensors; ``tgn_store_scatter_1d.launches`` counts
    its launches. Unlike the TPU kernel it needs no 128-row padding.
    """
    stores = dict(s_other=s_other, s_t=s_t, d_other=d_other, d_t=d_t)
    N1 = s_other.shape[0]
    for name, t in stores.items():
        if t.shape != (N1,):
            raise ValueError(f"{name} must have shape {(N1,)}, got {tuple(t.shape)}")
    E = rows_s.shape[0]
    updates = dict(rows_s=rows_s, vals_s_other=vals_s_other, vals_s_t=vals_s_t,
                   rows_d=rows_d, vals_d_other=vals_d_other, vals_d_t=vals_d_t)
    for name, t in updates.items():
        if t.shape != (E,):
            raise ValueError(f"{name} must have shape {(E,)}, got {tuple(t.shape)}")
    if not 0 <= last_live_row < N1 - 1:
        raise ValueError(f"last_live_row must be in [0, {N1 - 1}), got {last_live_row}")
    _require_int32(s_other.device, **stores, **updates)
    args = (s_other, s_t, d_other, d_t, rows_s, vals_s_other, vals_s_t,
            rows_d, vals_d_other, vals_d_t)
    if s_other.device.type == "cpu":
        return tgn_store_scatter_1d_plain(*args, last_live_row)
    if s_other.device.type != "cuda":
        raise ValueError(f"unsupported device {s_other.device}")
    if not all(t.is_contiguous() for t in stores.values()):
        raise ValueError("the stores must be contiguous: the kernel writes them in place")
    if E == 0:
        return s_other, s_t, d_other, d_t
    ins = [t.contiguous() for t in updates.values()]
    _native.launch("scatter_cells", "tgn_store_scatter_1d", [*stores.values(), *ins],
                   [E, last_live_row])
    tgn_store_scatter_1d.launches += 1
    return s_other, s_t, d_other, d_t


tgn_store_scatter_1d.launches = 0

# The message-store fields of a TGN memory state that the commit writes.
STORE_FIELDS = ("s_other", "s_t", "s_raw", "s_valid", "d_other", "d_t", "d_raw", "d_valid")


def store_winners(owner: torch.Tensor, t: torch.Tensor, valid: torch.Tensor,
                  N1: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The LastAggregator's plan of one role, by two ``segment_max`` calls
    (the JAX plan): among the valid events whose owner lies in [0, N1 - 2],
    each owner's latest event wins, the earliest batch position on equal
    times. Returns ``(winner, rows)``: the (E,) winner mask and each
    event's owner row, N1 - 1 (the dump row) for the others."""
    n = N1 - 1
    E = t.shape[0]
    idx = torch.arange(E, dtype=torch.int32, device=t.device)
    live = valid & (owner >= 0) & (owner < n)
    rows = torch.where(live, owner, n)
    tmax = segment_max(t, rows, N1, mask=live, initial=-1)
    is_max = live & (t == tmax[rows.long()])
    # Earliest batch position among the max-time messages, as an integer
    # max over -idx (the JAX code takes the same max in float).
    first = -segment_max(-idx, rows, N1, mask=is_max, initial=-E)
    winner = is_max & (idx == first[rows.long()])
    return winner, torch.where(winner, rows, n)


def tgn_store_commit_plain(state, src, dst, t, raw_msg, valid):
    """Plain version of ``tgn_store_commit``: per role, the winners of
    ``store_winners``, then K3's plain stores and masked ``index_put_``
    writes of the raw rows and valid flags."""
    N1 = state.s_other.shape[0]
    n = N1 - 1
    win_s, w_s = store_winners(src, t, valid, N1)
    win_d, w_d = store_winners(dst, t, valid, N1)
    tgn_store_scatter_1d_plain(state.s_other, state.s_t, state.d_other, state.d_t,
                               w_s, dst, t, w_d, src, t, n - 1)
    for winner, rows, store_raw, store_valid in ((win_s, w_s, state.s_raw, state.s_valid),
                                                 (win_d, w_d, state.d_raw, state.d_valid)):
        put_live(store_raw, (rows,), winner, raw_msg)
        put_live(store_valid, (rows,), winner, winner)
    return state


def tgn_store_commit(state, src: torch.Tensor, dst: torch.Tensor, t: torch.Tensor,
                     raw_msg: torch.Tensor, valid: torch.Tensor):
    """Store a batch's TGN messages, in place on a ``TGNMemoryState``.

    Per role (the src role into ``s_*``, the dst role into ``d_*``), among
    the valid events whose owner lies in [0, N1 - 2], the event with the
    largest time wins, the earliest batch position on equal times (the
    LastAggregator's choice, as ``tgm_tpu``'s ``tgn_store_messages``). The
    winner writes its counterpart (``dst`` for the src role, ``src`` for the
    dst role), its time, its ``raw_msg`` row and ``valid = True``. Rows
    without a winner, the dump row N1 - 1 and ``mem``/``last_update`` are
    not written. ``src``, ``dst``, ``t`` are (E,) int32, ``raw_msg`` (E, R)
    float32 (R may be 0), ``valid`` (E,) bool. On CUDA tensors one launch
    plans and writes everything and ``tgn_store_commit.launches`` counts it;
    on CPU tensors it runs the plain version. Returns ``state``.
    """
    N1 = state.s_other.shape[0]
    E = t.shape[0]
    if raw_msg.dim() != 2:
        raise ValueError(f"raw_msg must be (E, R), got shape {tuple(raw_msg.shape)}")
    R = raw_msg.shape[1]
    dev = state.s_other.device
    stores = [getattr(state, name) for name in STORE_FIELDS]
    i32, f32, b = torch.int32, torch.float32, torch.bool
    specs = list(zip(STORE_FIELDS, stores, (i32, i32, f32, b) * 2,
                     ((N1,), (N1,), (N1, R), (N1,)) * 2))
    specs += [("src", src, i32, (E,)), ("dst", dst, i32, (E,)), ("t", t, i32, (E,)),
              ("raw_msg", raw_msg, f32, (E, R)), ("valid", valid, b, (E,))]
    for name, x, dtype, shape in specs:
        if x.shape != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
    if dev.type == "cpu":
        return tgn_store_commit_plain(state, src, dst, t, raw_msg, valid)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not all(x.is_contiguous() for x in stores):
        raise ValueError("the stores must be contiguous: the kernel writes them in place")
    if E == 0:
        return state
    ins = [x.contiguous() for x in (src, dst, t, raw_msg, valid)]
    _native.launch("scatter_cells", "tgn_store_commit", [*stores, *ins], [E, N1, R])
    tgn_store_commit.launches += 1
    return state


tgn_store_commit.launches = 0
