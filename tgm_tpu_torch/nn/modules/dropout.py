"""Dropout drawn from an explicit generator (flax ``nn.Dropout`` semantics).

Every mask comes from the ``torch.Generator`` the caller passes, never from
the global RNG, so a train run is reproducible from its seed and a call
without a generator is deterministic whatever the module's train/eval mode.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator],
            mask_shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Keep each value with probability 1 - p, scaled by 1 / (1 - p); the
    identity without a generator or at p = 0, zeros at p = 1.

    ``mask_shape`` draws one mask of that shape, broadcast over ``x`` (flax
    attention's ``broadcast_dropout``); by default each value has its own.
    """
    if generator is None or p == 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    shape = x.shape if mask_shape is None else tuple(mask_shape)
    keep = torch.rand(shape, generator=generator, device=x.device) < 1.0 - p
    scale = 1.0 - p
    if x.dtype == torch.bfloat16:
        # flax divides by the keep rate as a constant of the input's dtype.
        scale = float(torch.tensor(scale).to(x.dtype))
    return torch.where(keep, x / scale, 0.0)


__all__ = ["dropout"]
