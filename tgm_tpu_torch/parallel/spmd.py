"""Node-sharded TGN and TGAT train steps over a process mesh.

The JAX package gets these steps from GSPMD: ``jax.jit(pipe.train_step)``
over inputs placed with ``parallel/sharding.py``'s layouts partitions
itself, and the result equals one device's. Here they are written out with
``torch.distributed`` collectives. ``sharded_tgn_train_step(pipe, mesh)``
and ``sharded_tgat_train_step(pipe, mesh)`` return ``train_step(carry,
batch) -> (carry, loss)`` with the single-device signature, so
``chain_epoch`` and ``scan_epoch`` take them; ``carry`` and ``batch`` are
``place``d (``tgn_carry_shardings`` / ``tgat_carry_shardings``, their
``_2d`` forms on a (data, model) mesh, ``batch_shardings``). The contract
is JAX's: the loss of one device and the same state rows.

One step on each rank, ``P`` ranks on the ``data`` axis:

* **Batch and parameters.** The rank's slice of the batch (padded to the
  longest slice with invalid rows) and the whole batch, gathered in global
  order, which every rank needs for the writes below. The negatives are
  drawn for the whole batch from the replicated generator, as on one
  device, and sliced. Each rank's loss is its slice's masked BCE sum over
  the whole batch's count of valid edges; the gradients are summed over
  ``data`` with one all-reduce, and the returned loss is the sum of the
  ranks' losses.
* **Owner computes.** Node ``v``'s rows live on the rank whose contiguous
  row range holds it (ids outside [0, N) on the last rank, whose dump row
  answers them, as the dump row answers them on one device). A request
  (the seeds of a recency query, the rows memory staging reads, and the
  memory of the counterparts ``s_other`` / ``d_other`` its winners name)
  is gathered from every rank (a few ints a request); each rank answers
  only the requests it owns, from its shard (kernel K1 or K4 over its own
  seeds for a query, row gathers for staging), and one ``all_to_all`` of
  the answers' bit patterns sends each back to the rank that asked: exact,
  whatever the dtype. The split sizes are read on the host (one sync a
  request).
* **Writes.** Every rank commits the staged rows, stores the messages and
  pushes the recency events of its own rows, from the whole batch in
  global batch order, so the LastAggregator's winner (the latest time,
  then the earliest position) and the ring's write plan are those of one
  device: the store commit runs once, over the batch with the ids encoded
  so that its own rows are written and a counterpart's global id survives
  (``_store_owned``); the push runs as one directed push of [src, dst |
  dst, src] whose events are valid only at their owners' rows.
* **2-D mesh.** The ``data`` axis as above; on ``model`` the parameters
  that ``tp_param_shardings`` splits live in the optimizer as this rank's
  rows. After the ``data`` all-reduce each rank steps its rows with its
  rows of the gradient, and the rows are gathered over ``model`` into the
  carry's modules, the working copy the next forward pass computes with
  (so they always hold the whole weights). Ranks of one ``model`` group
  hold the same state rows and batch slice and compute alike.

With gloo, the collectives' buffers of CUDA tensors are staged through
pinned host memory (``MeshAxis``); the compute stays on the card.

Every option of the two pipelines is taken:

* **Answers in bf16** (``feat_bf16``, ``attn_bf16``: bf16 feature rows,
  K/V rows and side-augmented rows) travel as their own bits, two to an
  int32 column (an odd row padded with one zero column): half the bytes of
  fp32 rows, and bit-equal on arrival.
* **Staging.** ``dedup_staging`` stages each distinct requested row once
  and gathers the staged rows back, as on one device. The packed memory
  state (``packed_state``) is staged from its packed rows and stored with
  its PyTorch scatters on the rank's rows (no store-commit launch, as on
  one device), its counterpart columns decoded as the unpacked ones are.
* **Packed recency** (``packed_recency``, eid layout): the owner answers a
  query as one device does (K1's pre-gathered entry, then the feature
  rows). Its push is one row write that resets the dump row after
  writing, so other ranks' events are marked invalid instead of aimed at
  the dump row.
* **The segment route** (``rowwise=False``). The encoder aggregates at the
  neighbours' rows, so a seed's embedding sums over every seed of the whole
  batch whose window holds it. Each rank therefore gathers the whole
  batch's seeds (negatives included) and query answers, stages the whole
  batch's distinct rows through owner requests, runs the encoder over the
  whole batch (its work repeated on every rank) and takes the loss of its
  own slice. The commit is the flush of its own src | dst rows with the
  old parameters, the reference order.

A mean-memory carry (``TGNMeanMemoryState``) raises ``TypeError``: no
pipeline of either package builds one (both build the last aggregator).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
from torch import nn

from ..constants import PADDED_NODE_ID
from ..hooks.neighbors import recency_pk_update
from ..nn.encoder.tgn import (
    TGNMemoryState,
    TGNPackedState,
    pending_rows,
    tgn_commit_staged,
    tgn_store_messages_packed,
)
from ..ops.scatter_cells import put_live, recency_push, tgn_store_commit
from ..train.programs import tgn_loss_and_grad, train_loss_and_grad
from ..train.tgn_pipeline import dedup_stage
from .mesh import MeshAxis
from .sharding import Sharding, is_split, tp_param_shardings
from .temporal import split_spans


def _width(like: torch.Tensor) -> int:
    """The int32 columns one row of ``like`` takes in ``_pack``'s buffer."""
    w = math.prod(like.shape[1:])
    return (w + 1) // 2 if like.element_size() == 2 else w


def _bits(x: torch.Tensor) -> torch.Tensor:
    """(L, W) int32 of the same bits as ``x`` (bool as 0 / 1): W its
    elements a row, or for a 2-byte dtype (bf16) its elements paired, an odd
    row padded with one zero column."""
    L, w = x.shape[0], math.prod(x.shape[1:])
    if w == 0:
        return torch.zeros((L, 0), dtype=torch.int32, device=x.device)
    if x.dtype in (torch.float32, torch.int32):
        return x.contiguous().view(torch.int32).reshape(L, w)
    if x.dtype == torch.bool:
        return x.int().reshape(L, w)
    if x.element_size() == 2:
        h = x.contiguous().view(torch.int16).reshape(L, w)
        if w % 2:
            h = torch.cat([h, h.new_zeros((L, 1))], dim=1)
        return h.view(torch.int32)
    raise TypeError(f"cannot exchange {x.dtype}")


def _pack(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([_bits(x) for x in xs], dim=1)


def _unpack(buf: torch.Tensor, likes: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``_pack``'s inverse: tensors of ``buf``'s rows with the row shapes and
    dtypes of ``likes``."""
    out, c = [], 0
    for like in likes:
        shape = (buf.shape[0],) + tuple(like.shape[1:])
        w = _width(like)
        x = buf[:, c : c + w].contiguous()
        if w == 0:
            x = torch.zeros(shape, dtype=like.dtype, device=buf.device)
        elif like.dtype == torch.float32:
            x = x.reshape(shape).view(torch.float32)
        elif like.dtype == torch.bool:
            x = x.reshape(shape) != 0
        elif like.element_size() == 2:
            x = x.view(torch.int16)[:, : math.prod(like.shape[1:])].reshape(shape).view(like.dtype)
        else:
            x = x.reshape(shape)
        out.append(x)
        c += w
    return out


class _Rows:
    """Which rank owns which node rows on the ``data`` axis: contiguous
    ranges of the N real rows balanced within one; ids outside [0, N) are
    the last rank's, answered from its dump row."""

    def __init__(self, num_nodes: int, axis: MeshAxis) -> None:
        self.N, self.P = num_nodes, axis.size
        spans = split_spans(num_nodes, axis.size)
        self.lo, self.hi = spans[axis.index]
        self.n = self.hi - self.lo  # local real rows; row n is the local dump row
        self.bounds = [hi for _, hi in spans[:-1]]

    def own(self, ids: torch.Tensor) -> torch.Tensor:
        return (ids >= self.lo) & (ids < self.hi)

    def owner(self, ids: torch.Tensor) -> torch.Tensor:
        """The rank that answers each id: its range's, the last for ids
        outside [0, N)."""
        bounds = torch.tensor(self.bounds, dtype=ids.dtype, device=ids.device)
        rank = torch.bucketize(ids, bounds, right=True)
        return torch.where((ids < 0) | (ids >= self.N), self.P - 1, rank)

    def local(self, ids: torch.Tensor, other: int) -> torch.Tensor:
        """Local row of each owned id; ``other`` for the rest."""
        return torch.where(self.own(ids), ids - self.lo, other).int()


class _Exchange:
    """Requests answered by their rows' owners over the ``data`` axis."""

    def __init__(self, axis: MeshAxis, rows: _Rows) -> None:
        self.axis, self.rows = axis, rows

    def gather(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Every rank's (L, ...) tensors, concatenated in rank order (equal L)."""
        buf = self.axis.all_gather(_pack(xs))
        buf = buf.reshape(-1, buf.shape[-1])
        return _unpack(buf, xs)

    def ask(self, ids: torch.Tensor, answer: Callable[..., Sequence[Optional[torch.Tensor]]],
            *extras: torch.Tensor) -> List[Optional[torch.Tensor]]:
        """``answer(local_rows, *extras)`` for this rank's (L,) global
        ``ids``, each answered by its owner from its shard.

        The requests (ids and extras, a few ints each) are gathered from
        every rank; each rank answers only those it owns, in rank order
        (ids outside [0, N) from the last rank's dump row), and one
        ``all_to_all`` sends each answer back to the rank that asked.
        Answers of None stay None."""
        L, P, me = ids.shape[0], self.axis.size, self.axis.index
        if P == 1:
            return list(answer(self.rows.local(ids, self.rows.n), *extras))
        all_ids, *all_extras = self.gather([ids, *extras])
        owner = self.rows.owner(all_ids)
        mine = (owner == me).nonzero().squeeze(1)  # grouped by the asking rank
        outs = answer(self.rows.local(all_ids[mine], self.rows.n), *(e[mine] for e in all_extras))
        real = [o for o in outs if o is not None]
        # counts[r][q]: rank r's requests that rank q owns.
        counts = (owner.reshape(P, 1, L) == torch.arange(P, device=ids.device)[:, None]
                  ).sum(-1).tolist()
        got = self.axis.all_to_all(_pack(real), [counts[r][me] for r in range(P)], counts[me])
        # The answers come grouped by owner, each group in request order.
        order = torch.sort(owner[me * L : (me + 1) * L], stable=True).indices
        buf = torch.empty_like(got)
        buf[order] = got
        got = iter(_unpack(buf, real))
        return [None if o is None else next(got) for o in outs]


class _GradHolder:
    """The working modules' parameters, for ``zero_every_grad`` when the
    optimizer holds parameter parts instead (tensor parallelism)."""

    def __init__(self, params: Sequence[nn.Parameter]) -> None:
        self.param_groups = [{"params": list(params)}]

    def zero_grad(self, set_to_none: bool = False) -> None:
        for p in self.param_groups[0]["params"]:
            if p.grad is not None:
                p.grad.zero_()


class _ShardedStep:
    """What the TGN and TGAT steps share: the axes, row owners, the batch
    gather, the parameter gather and the gradient reduction."""

    def __init__(self, pipe, mesh) -> None:
        self.pipe = pipe
        self.data = MeshAxis(mesh, "data")
        self.model = MeshAxis(mesh, "model")
        self.rows = _Rows(pipe.num_nodes, self.data)
        self.ex = _Exchange(self.data, self.rows)
        self.mesh = mesh

    def _layout(self, params: nn.Module) -> Dict[str, Sharding]:
        """The parameter layout ``place`` gave the carry: ``tp_param_shardings``
        where the mesh has a ``model`` axis of two ranks or more."""
        if self.model.size > 1:
            return tp_param_shardings(self.mesh, params)
        return {n: Sharding(self.mesh, ()) for n, _ in params.named_parameters()}

    def grad_owner(self, params: nn.Module, opt) -> Any:
        """What ``zero_every_grad`` takes: the optimizer, or the working
        modules' parameters where the optimizer holds parameter parts."""
        layout = self._layout(params)
        if not any(is_split(s) for s in layout.values()):
            return opt
        return _GradHolder(list(params.parameters()))

    def gather_params(self, params: nn.Module, opt) -> None:
        """Write the split parameters' whole values into the working modules
        (gathered over ``model``)."""
        layout = self._layout(params)
        with torch.no_grad():
            for (n, p), m in zip(params.named_parameters(), opt.param_groups[0]["params"]):
                if is_split(layout[n]):
                    p.copy_(self.model.all_gather(m.detach()).reshape(p.shape))

    def reduce_grads(self, params: nn.Module, opt) -> None:
        """Sum the gradients over ``data`` (one all-reduce); give each split
        parameter's rows their rows of the sum."""
        named = list(params.named_parameters())
        grads = [p.grad for _, p in named]
        flat = torch.cat([g.reshape(-1) for g in grads])
        self.data.all_reduce_(flat)
        c = 0
        for g in grads:
            g.copy_(flat[c : c + g.numel()].reshape(g.shape))
            c += g.numel()
        for (_, p), m in zip(named, opt.param_groups[0]["params"]):
            if m is not p:
                k = m.shape[0]
                m.grad = p.grad[self.model.index * k : (self.model.index + 1) * k].clone()

    def batch(self, batch, rng: torch.Generator) -> Dict[str, Any]:
        """The rank's slice padded to the longest slice, the whole batch
        gathered in global order (with those pads, all invalid), the global
        negatives' slice and the whole batch's valid-edge count."""
        B = getattr(batch, "global_size", batch.edge_src.shape[0])
        off = getattr(batch, "global_offset", 0)
        b = batch.edge_src.shape[0]
        bm = max(e - s for s, e in split_spans(B, self.data.size))
        dev = batch.edge_src.device

        def pad(x, fill):
            if x.shape[0] == bm:
                return x
            return torch.cat([x, torch.full((bm - b,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                                            device=dev)])

        valid = batch.edge_valid if batch.edge_valid is not None else torch.ones(
            b, dtype=torch.bool, device=dev)
        loc = {"src": pad(batch.edge_src.int(), PADDED_NODE_ID),
               "dst": pad(batch.edge_dst.int(), PADDED_NODE_ID),
               "t": pad(batch.edge_time.int(), 0), "valid": pad(valid, False)}
        if batch.has("edge_ids"):
            loc["eids"] = pad(batch.edge_ids.int(), -1)
        if batch.has("edge_x"):
            loc["x"] = pad(batch.edge_x.float(), 0.0)
        names = list(loc)
        whole = dict(zip(names, self.ex.gather([loc[k] for k in names])))
        neg = self.pipe.draw_neg(rng, B)[off : off + b]
        loc["neg"] = pad(torch.where(valid, neg.to(dev), PADDED_NODE_ID), PADDED_NODE_ID)
        denom = whole["valid"].sum().float().clamp_min(1.0)
        return dict(loc=loc, whole=whole, denom=denom)

    def query(self, select: Callable, state, seeds: torch.Tensor, seed_t: torch.Tensor):
        """``select(state_shard, local_seeds, seed_t)`` answered by each
        seed's owner (one K1 or K4 launch a rank)."""
        return self.ex.ask(seeds, lambda loc, t: select(state, loc, t), seed_t)

    def finish(self, params: nn.Module, opt, loss: torch.Tensor) -> torch.Tensor:
        """Reduce the gradients, step, bring the working modules up to date;
        returns the whole batch's loss."""
        self.reduce_grads(params, opt)
        opt.step()
        self.gather_params(params, opt)
        return self.data.all_reduce_(loss.clone())


def _events(w: Dict[str, torch.Tensor], first: torch.Tensor,
            second: Optional[torch.Tensor] = None):
    """The whole batch's undirected push as one directed one: (node, nbr, t,
    payload, valid) of [src -> dst | dst -> src], the payloads ``first`` and
    ``second`` (default ``first``)."""
    two = lambda a, b: torch.cat([a, b])
    return (two(w["src"], w["dst"]), two(w["dst"], w["src"]), two(w["t"], w["t"]),
            two(first, first if second is None else second), two(w["valid"], w["valid"]))


def _feats(w: Dict[str, torch.Tensor], rec_state) -> torch.Tensor:
    """The feature layout's payload: the batch's edge features (zeros without)."""
    if "x" in w:
        return w["x"]
    return torch.zeros((w["t"].shape[0], rec_state[2].shape[-1]), device=w["t"].device)


def _store_owned(rows: _Rows, state, w: Dict[str, torch.Tensor], raw: torch.Tensor) -> None:
    """The message store of the whole batch on this rank's rows.

    Owned ids go in as local rows, the others as ``-2 - id`` (negative: the
    store skips them as owners, and it writes them as counterparts); each
    written row's counterpart is then decoded back to its global id. The
    unpacked state is written by one store-commit launch, the packed one by
    ``tgn_store_messages_packed``'s scatters (its counterparts in ``meta``
    columns 1 and 4).
    """
    enc = lambda ids: torch.where(rows.own(ids), ids - rows.lo, -2 - ids).int()
    src, dst = enc(w["src"]), enc(w["dst"])
    if isinstance(state, TGNPackedState):
        tgn_store_messages_packed(state, src, dst, w["t"], raw, w["valid"])
        others = (state.meta[:, 1], state.meta[:, 4])
    else:
        tgn_store_commit(state, src, dst, w["t"], raw, w["valid"])
        others = (state.s_other, state.d_other)
    dec = lambda x: torch.where(x >= 0, x + rows.lo, -2 - x).int()
    for owner, other in zip((src, dst), others):
        live = w["valid"] & (owner >= 0)
        at = torch.where(live, owner, rows.n)
        put_live(other, (at,), live, dec(other[at.long()]))


def _push_owned(rows: _Rows, rec_state, events) -> None:
    """One directed push of the whole batch's (node, nbr, t, payload, valid)
    events: the single-device push's plan on this rank's rows.

    The ring layouts (four tensors): events of other ranks' rows aim at the
    local dump row, which the push never writes, as it never writes
    padding. The packed layout (``(buf, write_pos)``) is written by one row
    write that resets the dump row after writing, so those events are
    marked invalid instead.
    """
    nodes, nbrs, t, payload, valid = events
    local = rows.local(nodes, rows.n)
    if len(rec_state) == 2:
        recency_pk_update(rec_state, local, nbrs, t, payload, valid & rows.own(nodes),
                          directed=True)
        return
    ids, times, pay_buf, wp = rec_state
    recency_push(ids, times, pay_buf, wp, local, nbrs.int(), t.int(), payload.to(pay_buf.dtype),
                 valid, directed=True)


class _TGNStep(_ShardedStep):
    def __call__(self, carry, batch):
        params, opt, mem, rec, rng = carry
        if not isinstance(mem, (TGNMemoryState, TGNPackedState)):
            raise TypeError(f"the sharded TGN step takes the last aggregator's state "
                            f"(TGNMemoryState or TGNPackedState), got {type(mem).__name__}: no "
                            f"pipeline of either package builds a mean-memory carry")
        pipe, ex, rows = self.pipe, self.ex, self.rows
        memory = params["mem"]
        zero = self.grad_owner(params, opt)
        bt = self.batch(batch, rng)
        loc, w = bt["loc"], bt["whole"]
        bm = loc["src"].shape[0]
        seeds = torch.cat([loc["src"], loc["dst"], loc["neg"]])
        nbrs, nbr_t, nbr_x = self.query(pipe._query, rec, seeds, loc["t"].repeat(3))

        def fetch_mem(ids):
            return ex.ask(ids.clamp(0, rows.N).int(), lambda l: (mem.mem[l.long()],))[0]

        def stage(ids):
            got = ex.ask(ids.int(), lambda l: (mem.mem[l.long()], *pending_rows(mem, l.long())))
            return memory.stage_rows(got[0], got[1:], fetch_mem)

        nodes = torch.cat([w["src"], w["dst"]])
        nodes = torch.where(torch.cat([w["valid"], w["valid"]]), nodes, rows.N)
        if pipe.rowwise:
            if pipe.dedup_staging:
                stage = dedup_stage(stage, rows.N)
            loss, (st_mem, st_last) = tgn_loss_and_grad(
                memory, params["enc"], params["dec"], zero, mem, seeds, nbrs, nbr_t, nbr_x,
                loc["valid"], stage=stage, denom=bt["denom"])
            # The train-mode commit of the whole batch's src | dst rows.
            st_mem, st_last = ex.gather([st_mem.reshape(2, bm, -1).transpose(0, 1).reshape(bm, -1),
                                         st_last.reshape(2, bm).T.contiguous()])
            M = mem.mem.shape[1]
            st_mem = st_mem.reshape(-1, 2, M).transpose(0, 1).reshape(-1, M)
            st_last = st_last.T.reshape(-1)
        else:
            loss = train_loss_and_grad(
                zero, lambda: self._segment_rows(params, seeds, nbrs, nbr_t, nbr_x, stage),
                params["dec"], loc["valid"], bt["denom"])
            # The flush of this rank's src | dst rows with the old parameters.
            with torch.no_grad():
                local = rows.local(nodes, rows.n).long()
                st_mem, st_last = memory.stage_rows(mem.mem[local], pending_rows(mem, local),
                                                    fetch_mem)
        # The commit, then the message store, then the push: each rank
        # writes its own rows.
        tgn_commit_staged(mem, rows.local(nodes, PADDED_NODE_ID), st_mem, st_last)
        raw = w["x"] if "x" in w else torch.zeros((w["t"].shape[0], 0), device=w["t"].device)
        _store_owned(rows, mem, w, raw)
        _push_owned(rows, rec, _events(w, w["eids"] if pipe.edge_x_full is not None
                                       else _feats(w, rec)))
        loss = self.finish(params, opt, loss)
        return type(carry)(params, opt, mem, rec, rng), loss

    def _segment_rows(self, params, seeds, nbrs, nbr_t, nbr_x, stage) -> torch.Tensor:
        """This rank's [src | dst | neg] embedding rows on the segment route:
        the whole batch's seeds and query answers gathered, put in batch
        order ([src | dst | neg] of the whole batch, each in rank order) and
        embedded as on one device, ``stage`` fetching the rows from their
        owners."""
        P, me = self.data.size, self.data.index
        bm = seeds.shape[0] // 3

        def batch_order(x):
            rest = tuple(x.shape[1:])
            return x.reshape((P, 3, bm) + rest).transpose(0, 1).reshape((3 * P * bm,) + rest)

        whole = [batch_order(x) for x in self.ex.gather([seeds, nbrs, nbr_t, nbr_x])]
        z = self.pipe._segment_embed(params, None, *whole, stage=stage)
        return z.reshape(3, P, bm, -1)[:, me].reshape(3 * bm, -1)


class _TGATStep(_ShardedStep):
    def __call__(self, carry, batch):
        params, opt, rec, rng = carry
        pipe = self.pipe
        zero = self.grad_owner(params, opt)
        bt = self.batch(batch, rng)
        loc, w = bt["loc"], bt["whole"]
        seeds = torch.cat([loc["src"], loc["dst"], loc["neg"]])

        def select(state, hop, s, t):
            return self.query(lambda st, l, tt: pipe._select_hop(st, hop, l, tt), state, s, t)

        hops, kv = pipe._hops(rec, seeds, loc["t"].repeat(3), select=select)
        loss = train_loss_and_grad(zero, lambda: pipe._embed(params, hops, kv), params["dec"],
                                   loc["valid"], bt["denom"])
        if pipe.aug_x is not None:  # side-augmented payloads 2 * eid + side
            events = _events(w, w["eids"] * 2 + 1, w["eids"] * 2)
        else:
            events = _events(w, w["eids"] if pipe.edge_x_full is not None else _feats(w, rec))
        _push_owned(self.rows, rec, events)
        loss = self.finish(params, opt, loss)
        return type(carry)(params, opt, rec, rng), loss


def sharded_tgn_train_step(pipe, mesh):
    """``train_step(carry, batch) -> (carry, loss)`` of a ``TGNPipeline``
    (every option: rowwise or segment, eid or feature recency layout, packed
    memory or recency, the bf16 options, ``dedup_staging``) over ``mesh``:
    a ``tgn_carry_shardings`` placed carry (``tgn_carry_shardings_2d`` on a
    mesh with a ``model`` axis of two ranks or more) and a
    ``batch_shardings`` placed batch."""
    return _TGNStep(pipe, mesh)


def sharded_tgat_train_step(pipe, mesh):
    """``train_step(carry, batch) -> (carry, loss)`` of a ``TGATPipeline``
    (every recency layout, ``feat_bf16`` and ``attn_bf16``) over ``mesh``,
    from a ``tgat_carry_shardings`` (or ``_2d``) placed carry and a
    ``batch_shardings`` placed batch."""
    return _TGATStep(pipe, mesh)


__all__ = ["sharded_tgat_train_step", "sharded_tgn_train_step"]
