"""Operand rounding of the plain references: a matmul of operands rounded
to a lower format, accumulated in fp32, as the tensor cores compute it."""

from __future__ import annotations

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round fp32 to TF32 (10 mantissa bits, nearest, ties away), as fp32."""
    b = x.float().contiguous().view(torch.int32)
    r = (b + 0x1000) & ~0x1FFF
    keep = ((b >> 23) & 0xFF) == 0xFF  # inf and nan pass through
    return torch.where(keep, b, r).view(torch.float32)


def bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (nearest even), as fp32."""
    return x.to(torch.bfloat16).float()


def fp8(x: torch.Tensor) -> torch.Tensor:
    """Round to fp8 e4m3 with one per-tensor scale (amax to 448), as fp32."""
    amax = x.detach().abs().amax().float().clamp_min(1e-12)
    s = 448.0 / amax
    return (x.float() * s).to(torch.float8_e4m3fn).float() / s


ROUND = {"fp32": lambda x: x, "tf32": tf32, "bf16": bf16, "fp8": fp8}


def mm(a: torch.Tensor, b: torch.Tensor, fmt: str) -> torch.Tensor:
    """``a @ b`` of operands rounded to ``fmt``, fp32 sums."""
    r = ROUND[fmt]
    return r(a) @ r(b)
