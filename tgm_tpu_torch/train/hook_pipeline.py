"""Hook-pipeline epochs (port of ``tgm_tpu/train/hook_pipeline.py``).

``scanned_hook_epoch`` has the signature and return of the JAX function:
the epoch is a plain Python loop over the stream's batches, each batch going
through the key's hook DAG and then the model step. PyTorch runs eagerly, so
there is nothing to compile: ``donate``, ``compiler_options`` and ``unroll``
are accepted and have no effect, as ``jit_scan_epoch`` treats
``donate_carry`` and ``unroll``. ``hook_epoch`` is the same function.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

from ..core.graph import DGraph
from .epoch import stack_outs


def scanned_hook_epoch(
    stream: Any,
    hm: Any,
    key: str,
    dg: DGraph,
    step_fn: Callable[[Any, Any], Tuple[Any, Any]],
    donate: bool = True,
    compiler_options: Any = None,
    unroll: int = 1,
):
    """One epoch over ``stream`` with ``key``'s hook pipeline.

    Returns ``(epoch_fn, init_hook_states)`` with
    ``epoch_fn(carry, hook_states) -> (carry, hook_states, outs)``, where
    ``step_fn(carry, hook_enriched_batch) -> (carry, out)`` is the model step
    and ``outs`` stacks each batch's ``out`` along a new first axis. Existing
    hook state is reused; hooks without live state are initialized from ``dg``.
    """
    hook_fn, init_states = hm.as_transform(key, dg)

    def epoch(carry, hook_states):
        outs = []
        for i in range(stream.num_batches):
            batch = stream.batch_at(i)
            hook_states, batch = hook_fn(hook_states, batch)
            carry, out = step_fn(carry, batch)
            outs.append(out)
        return carry, hook_states, stack_outs(outs)

    return epoch, init_states


hook_epoch = scanned_hook_epoch

__all__ = ["hook_epoch", "scanned_hook_epoch"]
