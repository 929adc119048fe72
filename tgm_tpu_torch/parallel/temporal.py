"""Temporal-axis parallelism: the event stream split into spans (port of
``tgm_tpu/parallel/temporal.py``).

The time-sorted edge stream is split into contiguous spans of batches.
Carried state (TGN memory, recency buffers) makes the stream sequential, so
there are two training schedules and one exact evaluation schedule:

* ``chain_epoch``: exact. Spans run in order, each from the previous span's
  final carry; the losses equal one ``scan_epoch`` over the epoch.
* ``stale_parallel_epoch`` / ``stale_resync_epoch``: DistTGL-style bounded
  staleness. Every span runs from the same start carry (the round's), then
  ``merge_stale_carries`` merges them owner-wise: each node row comes from
  the span that touched it last (largest ``last_update`` for the memory,
  largest write position for the recency buffers), parameters and Adam's
  moments are averaged, and Adam's ``step`` is span 0's.
* ``pipelined_eval_epoch``: exact evaluation with a cheap sequential state
  prologue (``advance_fn``) that hands each span its start carry, then
  every span scores from its own.

The JAX package runs the spans of a round as one ``vmap``; here they run
one after another on one device. The port's steps update their carry in
place (the push and the store commit write the state tensors, Adam and the
``ModuleDict`` are mutated), so every span starts from its own copy of the
start carry (``copy_carry``): cloned state tensors, deep-copied modules
with an Adam rebuilt over them holding the same state, and a generator
with the same state. As in JAX, where every span gets the same ``rng``,
every span draws the same negatives. "Stacked on axis 0" in the JAX
docstrings reads here as a list of carries indexed by span.

Short spans: spans are padded to the longest; a padded slot runs no step
and reads 0 in the (spans, L) losses, as JAX's skipped ``lax.cond``
branch leaves it.

ROADMAP fault 26: the merge keys ``last_update * n_spans + span_id`` and
``write_pos * n_spans + span_id`` are int32, as in JAX, and wrap once a
time passes 2^31 / n_spans (Unix seconds, about 1.7e9, with two spans or
more); ``argmax`` then picks another span. The port computes them as JAX
does, wrap included.
"""

from __future__ import annotations

import copy
from typing import Any, List, Optional, Sequence, Tuple

import torch

from ..nn.encoder.tgn import TGNMemoryState
from ..train.epoch import scan_epoch, stack_outs


def split_spans(num_batches: int, n_spans: int) -> List[Tuple[int, int]]:
    """Contiguous [start, end) batch-index spans, balanced within ±1."""
    base = num_batches // n_spans
    rem = num_batches % n_spans
    spans, start = [], 0
    for i in range(n_spans):
        size = base + (1 if i < rem else 0)
        spans.append((start, start + size))
        start += size
    return spans


def _copy(x: Any, memo: dict) -> Any:
    if isinstance(x, torch.Generator):
        g = torch.Generator(device=x.device)
        g.set_state(x.get_state())
        return g
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_copy(v, memo) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_copy(v, memo) for v in x)
    # Modules and optimizers share one memo, so the copied Adam holds the
    # copied modules' parameters with copies of its state.
    return copy.deepcopy(x, memo)


def copy_carry(carry: Any) -> Any:
    """An independent copy of a carry (``TGNCarry``, ``TGATCarry`` or any
    named tuple of modules, optimizers, tensors and generators): a step on
    the copy leaves ``carry`` as it was."""
    memo: dict = {}
    return type(carry)(*(_copy(v, memo) for v in carry))


def chain_epoch(step_fn, batch_at, carry, num_batches: int, n_spans: int):
    """Exact sequential execution over spans (state handed off at boundaries).

    Returns ``(final_carry, per-batch losses)``: the same as one
    ``scan_epoch`` over the epoch. The span structure is the unit of
    placement for runs over several hosts (each scans its own span).
    """
    losses = []
    for start, end in split_spans(num_batches, n_spans):
        if end <= start:
            continue
        carry, span_losses = scan_epoch(step_fn, lambda i: batch_at(start + i), carry,
                                        end - start)
        losses.append(span_losses)
    return carry, torch.cat(losses) if losses else torch.zeros((0,))


def _fill_slots(slots: List[List[Any]]) -> Any:
    """Stack (spans, L) outputs, zeros (of the first real output's shapes)
    in the slots that ran no step."""
    real = next((o for row in slots for o in row if o is not None), None)
    if real is None:
        return torch.zeros((len(slots), len(slots[0]) if slots else 0))
    zero = (tuple(torch.zeros_like(x) for x in real) if isinstance(real, tuple)
            else torch.zeros_like(real))
    return stack_outs([stack_outs([zero if o is None else o for o in row]) for row in slots])


def _stale_span_range(step_fn, batch_at, carry, start: int, end: int, n_spans: int,
                      num_batches: int, carry_stacked: bool = False):
    """Run batches [start, end) as ``n_spans`` spans, each from its own copy
    of ``carry`` (or from ``carry[s]``, its own, when ``carry_stacked``).

    Returns ``(per-span final carries, losses (spans, L))``; the padded
    slots of shorter spans run no step and read 0.
    """
    spans = [(start + s, start + e) for s, e in split_spans(end - start, n_spans)]
    span_len = max(e - s for s, e in spans)
    carries, slots = [], []
    for d, (s0, e0) in enumerate(spans):
        c = carry[d] if carry_stacked else copy_carry(carry)
        row: List[Optional[torch.Tensor]] = [None] * span_len
        for j in range(e0 - s0):
            c, row[j] = step_fn(c, batch_at(min(s0 + j, num_batches - 1)))
        carries.append(c)
        slots.append(row)
    return carries, _fill_slots(slots)


def stale_parallel_epoch(step_fn, batch_at, carry, num_batches: int, n_spans: int):
    """Run every span from the same starting carry (each from its own copy).

    Returns ``(per-span final carries, losses (spans, L))``. Use
    ``merge_stale_carries`` to collapse the spans.
    """
    return _stale_span_range(step_fn, batch_at, carry, 0, num_batches, n_spans, num_batches)


def _clone_state(tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(x.clone() for x in tree))
    return tuple(x.clone() for x in tree)


def stale_resync_epoch(
    step_fn,
    batch_at,
    carry,
    num_batches: int,
    n_spans: int,
    num_nodes: int,
    resync_rounds: int,
    merge_params_each_round: bool = True,
):
    """Bounded staleness with periodic resync: the epoch runs as
    ``resync_rounds`` rounds; each round runs its batch range as ``n_spans``
    spans from the round-start carry, then merges them owner-wise
    (``merge_stale_carries``). The staleness window shrinks from
    ``num_batches / n_spans`` to ``num_batches / (resync_rounds * n_spans)``.

    ``merge_params_each_round=False`` resyncs only the carried STATE (memory
    and recency buffers) each round: every span keeps its own parameters,
    Adam and generator until the epoch's last merge averages them.

    Returns ``(final carry, list of per-round (spans, L) loss tensors)``.
    With ``resync_rounds == 1`` this is ``stale_parallel_epoch`` and one
    merge; with ``n_spans == 1`` it is the sequential schedule.
    """
    all_losses = []
    stacked = None
    merged = carry
    for rs, re in split_spans(num_batches, resync_rounds):
        if re <= rs:
            continue
        carries, losses = _stale_span_range(
            step_fn, batch_at, stacked if stacked is not None else merged,
            rs, re, n_spans, num_batches, carry_stacked=stacked is not None,
        )
        merged = merge_stale_carries(carries, num_nodes)
        if not merge_params_each_round:
            # Every span takes a copy of the merged state and keeps its own
            # params, Adam and generator.
            stacked = [c._replace(mem_state=_clone_state(merged.mem_state),
                                  rec_state=_clone_state(merged.rec_state)) for c in carries]
        all_losses.append(losses)
    return merged, all_losses


def pipelined_eval_epoch(advance_fn, score_fn, carry, num_batches: int, n_spans: int):
    """EXACT temporal-parallel evaluation via pipelined span handoff.

    * phase A (sequential prologue): ``advance_fn(carry, i) -> carry`` over
      spans 0..n-2 from a copy of ``carry``, keeping a copy of the carry at
      each span start (the handoff states);
    * phase B: every span runs ``score_fn(carry, i) -> (carry, out)`` over
      its batches from its own start carry (recomputing the state advance).

    ``advance_fn`` must advance the state exactly as ``score_fn`` does (e.g.
    ``TGNPipeline.eval_advance_state`` and ``eval_step``); the outputs are
    then bit-equal to the sequential run. ``carry`` is left as it was.

    Returns ``(per-span outs stacked (spans, span_len, ...), valid mask
    (spans, span_len))``; the padded slots of shorter spans are zeros.
    """
    spans = split_spans(num_batches, n_spans)
    starts = [copy_carry(carry)]
    c = copy_carry(carry)
    for s, e in spans[:-1]:
        for i in range(s, e):
            c = advance_fn(c, i)
        starts.append(copy_carry(c))

    span_len = max(e - s for s, e in spans)
    slots = []
    for (s, e), c0 in zip(spans, starts):
        row: List[Any] = [None] * span_len
        for j in range(e - s):
            c0, row[j] = score_fn(c0, s + j)
        slots.append(row)
    outs = _fill_slots(slots)
    lens = torch.tensor([e - s for s, e in spans])
    valid = torch.arange(span_len)[None, :] < lens[:, None]
    dev = (outs[0] if isinstance(outs, tuple) else outs).device
    return outs, valid.to(dev)


def _pick_rows(stacked: torch.Tensor, winner: torch.Tensor) -> torch.Tensor:
    """(spans, N1, ...) -> (N1, ...): row n from span ``winner[n]``."""
    return stacked[winner, torch.arange(stacked.shape[1], device=stacked.device)]


def _winner(order: torch.Tensor) -> torch.Tensor:
    """The span with the largest int32 key ``order * n_spans + span_id``
    per row (the later span on ties), computed in int32 as JAX does: the
    key wraps past 2^31 (ROADMAP fault 26)."""
    n_spans = order.shape[0]
    span_ids = torch.arange(n_spans, dtype=torch.int32, device=order.device)[:, None]
    key = order.int() * n_spans + span_ids
    return torch.argmax(key, dim=0)


def _mean(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.stack(list(xs)).mean(dim=0)


def merge_stale_carries(carries: Sequence[Any], num_nodes: int):
    """Collapse the spans: owner-wise state merge and parameter average.

    Each node row of the memory state comes from the span with the largest
    ``last_update`` for it, each row of the recency state from the span
    with the largest write position (``rec[3]``), the later span on ties;
    parameters and Adam's moments are averaged over the spans, Adam's
    ``step`` and the generator are span 0's. ``carries`` are ``TGNCarry``s
    with a ``TGNMemoryState``; they are left as they were.
    """
    mems = [c.mem_state for c in carries]
    if not isinstance(mems[0], TGNMemoryState):
        raise TypeError(f"merge_stale_carries takes a TGNMemoryState, got "
                        f"{type(mems[0]).__name__}")
    lu = torch.stack([m.last_update for m in mems])
    winner_mem = _winner(lu)
    mem_merged = TGNMemoryState(*(_pick_rows(torch.stack(list(f)), winner_mem)
                                  for f in zip(*mems)))

    recs = [c.rec_state for c in carries]
    winner_rec = _winner(torch.stack([r[3] for r in recs]))
    rec_merged = tuple(_pick_rows(torch.stack(list(f)), winner_rec) for f in zip(*recs))

    memo: dict = {}
    params = copy.deepcopy(carries[0].params, memo)
    opt = copy.deepcopy(carries[0].opt_state, memo)
    named = [dict(c.params.named_parameters()) for c in carries]
    with torch.no_grad():
        for name, p in params.named_parameters():
            span_params = [n[name] for n in named]
            p.copy_(_mean([q.detach() for q in span_params]))
            states = [c.opt_state.state.get(q) for c, q in zip(carries, span_params)]
            if states[0]:
                opt.state[p] = {
                    k: (v.clone() if k == "step" or not torch.is_floating_point(v)
                        else _mean([s[k] for s in states]))
                    for k, v in states[0].items()
                }
    return type(carries[0])(params, opt, mem_merged, rec_merged, _copy(carries[0].rng, {}))


__all__ = [
    "chain_epoch",
    "copy_carry",
    "merge_stale_carries",
    "pipelined_eval_epoch",
    "split_spans",
    "stale_parallel_epoch",
    "stale_resync_epoch",
]
