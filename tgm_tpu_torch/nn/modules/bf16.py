"""bf16 arithmetic at the points where the JAX package's flax modules round.

The JAX package's bf16 options (``TemporalAttention.kv_bf16``, the rowwise
TGN attention's ``kv_bf16``, ``DyGFormer.compute_bf16`` and ``bf16_stream``)
compute in bf16 by flax's dtype rules (``flax/linen/linear.py``,
``normalization.py``, ``attention.py``) and jax.numpy's promotion:

* ``nn.Dense(dtype=bf16)`` casts its input, kernel and bias to bf16. The
  product accumulates in fp32 and is rounded to bf16; the bias is then added
  in bf16, a second rounding. ``dense``.
* ``jnp.einsum(..., preferred_element_type=float32)`` of bf16 operands: the
  fp32 products of the bf16 values, summed in fp32, not rounded.
  ``einsum_f32``.
* Any other op whose operands are all bf16 (an einsum without
  ``preferred_element_type``, an add, a softmax's steps, ``gelu``'s steps)
  rounds its result to bf16. ``jnp.sum`` and ``jnp.mean`` of bf16 sum in
  fp32 and round the result once.
* A bf16 operand meeting an fp32 one promotes to fp32: no rounding.
  ``nn.LayerNorm()`` (``dtype=None``, fp32 parameters) returns fp32 for a
  bf16 input, its statistics from the fast variance E[x²] - E[x]².
  ``flax_layer_norm``.

The port rounds at those points and nowhere else. A bf16 product here is the
fp32 product of the bf16-rounded operands: each product of two bf16 values
is exact in fp32, so only the order of the fp32 sums is the library's. TF32
does not change that: a bf16 significand fits TF32's, so a tensor core
takes the operands unchanged whether ``allow_tf32`` is set or not.

JAX computed op by op rounds exactly there, and so does a jitted JAX
program compiled with XLA's ``xla_allow_excess_precision`` off, which the
tests compare with. By default XLA may round at fewer points: it keeps an
elementwise bf16 result in fp32 where it fuses it into a consumer that
widens it. The port follows the source.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

BF16 = torch.bfloat16


def dense(x: torch.Tensor, linear: nn.Linear, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)`` with ``linear``'s fp32 weights: for
    ``None`` the fp32 layer (a bf16 input promotes exactly); for bf16 the
    input, kernel and bias in bf16, the fp32-accumulated product rounded to
    bf16, then the bias added in bf16."""
    if dtype is None:
        return linear(x.float())
    y = (x.to(dtype).float() @ linear.weight.to(dtype).float().T).to(dtype)
    return y if linear.bias is None else y + linear.bias.to(dtype)


def einsum_f32(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum(..., preferred_element_type=float32)``: fp32 products of
    the operands as they are (bf16 or fp32), fp32 sums."""
    return torch.einsum(equation, *(o.float() for o in operands))


def flax_layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """flax ``nn.LayerNorm()`` with ``ln``'s weights on a bf16 or fp32 input:
    fp32 statistics by the fast variance (clamped at 0), fp32 output."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return (xf - mu) * (torch.rsqrt(var + ln.eps) * ln.weight) + ln.bias


def softmax_bf16(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.softmax`` of a bf16 tensor, each step rounded: x - max, exp,
    the fp32 sum rounded once, the quotient."""
    e = torch.exp(x - x.amax(dim, keepdim=True))
    return e / e.float().sum(dim, keepdim=True).to(x.dtype)


_SQRT_HALF_BF16 = float(torch.tensor(math.sqrt(0.5)).to(BF16))


def gelu_bf16(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=False)`` of a bf16 tensor:
    ``0.5 * x * erfc(-x * bf16(sqrt(0.5)))``, each step rounded."""
    return (0.5 * x) * torch.special.erfc(-x * _SQRT_HALF_BF16)


class LayerNormBF16(nn.Module):
    """The JAX ``LayerNormBF16``: fp32 mean and (two-pass) variance of the
    input, ``(y * scale + bias)`` in fp32, the output rounded to bf16.
    ``weight`` and ``bias`` are flax's ``scale`` and ``bias``."""

    def __init__(self, dim: int, eps: float = 1e-5) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(BF16)


__all__ = [
    "BF16",
    "LayerNormBF16",
    "dense",
    "einsum_f32",
    "flax_layer_norm",
    "gelu_bf16",
    "softmax_bf16",
]
