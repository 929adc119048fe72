"""Snapshot (discrete-time) epochs over a precomputed schedule (port of
``tgm_tpu/train/snapshot.py``).

A snapshot example interleaves two loaders: a discretized snapshot loader
advances the recurrent state while an event loader drives prediction
batches, and after each event batch the snapshots advance while the
batch's max time lies past the current snapshot's end. Both loaders'
plans are known on the host before the epoch starts, so the merged order
is precomputed (``merged_snapshot_schedule``, numpy, copied from the JAX
package). The JAX package runs the schedule as one ``lax.scan``;
``scanned_snapshot_epoch`` runs it as a Python loop whose per-step
outputs stay on the device until the caller reads them, so no step waits
for the card.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import numpy as np
import torch


def plan_edge_max_times(plan, edge_times: np.ndarray) -> np.ndarray:
    """Per-batch max edge time of a host ``BatchPlan``.

    ``edge_times`` is the split's time-sorted edge times, so a batch's max
    is its window's last row. Batches without edges report 0 (the max of a
    zero-padded empty window).
    """
    off = plan.edge_offsets
    cnt = plan.edge_counts
    last = np.clip(off + cnt - 1, 0, max(len(edge_times) - 1, 0))
    out = np.where(cnt > 0, edge_times[last], 0)
    return out.astype(np.int64)


def merged_snapshot_schedule(
    snap_max_times: np.ndarray,
    batch_max_times: np.ndarray,
    conversion: int,
    apply_first: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """The (kind, index) steps of the two-loader interleave.

    Kind 0 advances the snapshot recurrence with snapshot batch ``idx``;
    kind 1 trains or evaluates on event batch ``idx``. The first snapshot
    comes before any event batch, and after each event batch snapshots
    advance while ``t_max > (snap_end + 1) * conversion`` (``snap_end`` in
    snapshot ticks, ``t_max`` in raw time units) until they run out.

    ``apply_first=False`` is the eval loops' rule: the first snapshot only
    sets the initial ``snap_end`` and is not run through the encoder (the
    recurrent state arrives from training).
    """
    kinds: list[int] = []
    idxs: list[int] = []
    n_snap = len(snap_max_times)
    si = 0
    snap_end = None
    if n_snap > 0:
        if apply_first:
            kinds.append(0)
            idxs.append(0)
        snap_end = int(snap_max_times[0])
        si = 1
    for b, tmax in enumerate(batch_max_times):
        kinds.append(1)
        idxs.append(b)
        if snap_end is None:
            continue
        while si < n_snap and int(tmax) > (snap_end + 1) * conversion:
            kinds.append(0)
            idxs.append(si)
            snap_end = int(snap_max_times[si])
            si += 1
    return np.asarray(kinds, np.int32), np.asarray(idxs, np.int32)


def scanned_snapshot_epoch(
    kinds: np.ndarray,
    idxs: np.ndarray,
    snap_batch_at: Callable[[int], Any],
    edge_batch_at: Callable[[int], Any],
    snapshot_core: Callable[[Any, Any], Any],
    edge_core: Callable[[Any, Any, int], Tuple[Any, Tuple[torch.Tensor, torch.Tensor]]],
):
    """``epoch(carry) -> (carry, a, b)`` over the merged schedule.

    ``snapshot_core(carry, snapshot_batch) -> carry`` advances the
    recurrence; ``edge_core(carry, event_batch, batch_idx) -> (carry, (a,
    b))`` handles a prediction batch and gives a scalar pair: (loss, 1) in
    training, (mrr_sum, count) in evaluation. ``a`` and ``b`` are fp32, one
    entry a step (0 on snapshot steps), on the device of the edge steps'
    outputs; the epoch metric is ``sum(a) / sum(b)``.
    """
    steps = list(zip(np.asarray(kinds).tolist(), np.asarray(idxs).tolist()))

    def epoch(carry):
        outs = []
        for kind, idx in steps:
            if kind == 0:
                carry = snapshot_core(carry, snap_batch_at(idx))
                outs.append(None)
            else:
                carry, (a, b) = edge_core(carry, edge_batch_at(idx), idx)
                outs.append((a.float(), b.float()))
        zero = next((o[0].new_zeros(()) for o in outs if o is not None), torch.zeros(()))
        column = lambda j: torch.stack([zero if o is None else o[j] for o in outs]
                                       if outs else [zero])[: len(outs)]
        return carry, column(0), column(1)

    return epoch


__all__ = ["merged_snapshot_schedule", "plan_edge_max_times", "scanned_snapshot_epoch"]
