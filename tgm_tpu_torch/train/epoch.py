"""Whole-epoch execution (port of ``tgm_tpu/train/epoch.py``).

The JAX package runs an epoch as one ``lax.scan`` program; PyTorch runs
eagerly, so an epoch here is a Python loop over ``batch_at(i)`` whose
per-step outputs are stacked once at the end. The loop never waits for the
card: a step's outputs stay on the device until the caller reads them.

``StaticTablesMixin`` and ``jit_scan_epoch``'s ``tables``/``bind`` keep
large constants out of a jitted XLA program; an eager step reads its tables
directly, so they are not ported (ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch


def stack_outs(outs: List[Any]) -> Any:
    """Stack per-step outputs (tensors, or tuples of them) along a new first axis."""
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(list(col)) for col in zip(*outs))
    return torch.stack(outs)


def scan_epoch(
    step_fn: Callable[[Any, Any], Tuple[Any, Any]],
    batch_at: Callable[[int], Any],
    carry: Any,
    num_batches: int,
    unroll: int = 1,
) -> Tuple[Any, Any]:
    """Run ``num_batches`` steps ``carry, out = step_fn(carry, batch_at(i))``.

    Returns ``(carry, outs)`` with the outputs stacked. ``unroll`` is
    accepted for the JAX signature and has no effect.
    """
    outs = []
    for i in range(num_batches):
        carry, out = step_fn(carry, batch_at(i))
        outs.append(out)
    return carry, stack_outs(outs)


def jit_scan_epoch(step_fn, batch_at, num_batches: int, donate_carry: bool = True,
                   unroll: int = 1):
    """Return ``epoch(carry) -> (carry, outs)`` running ``scan_epoch``.

    ``donate_carry`` and ``unroll`` are accepted for the JAX signature and
    have no effect: the port's steps update their carry's tensors in place
    whatever ``donate_carry`` says, so a carry passed in is consumed.
    """

    def epoch(carry):
        return scan_epoch(step_fn, batch_at, carry, num_batches)

    return epoch


__all__ = ["jit_scan_epoch", "scan_epoch", "stack_outs"]
