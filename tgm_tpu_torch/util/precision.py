"""Backend-dependent precision policy (port of ``tgm_tpu/util/precision.py``).

The JAX package turns its explicit-bf16 paths (``TemporalAttention.kv_bf16``,
``DyGFormer.compute_bf16``, the pipelines' ``attn_bf16``) on by default for
TPU backends only, where the matrix unit already rounds fp32 operands to
bf16. On CPUs and GPUs they stay fp32. The port runs on an H100 or a CPU,
so its automatic choice is always off; ``"on"`` forces the bf16 paths.
"""

from __future__ import annotations

from typing import Optional, Union


def tpu_default_bf16() -> bool:
    """True when the default backend benefits from the explicit-bf16 paths:
    a TPU, which the port never runs on."""
    return False


def resolve_bf16(choice: Optional[Union[str, bool]]) -> bool:
    """Resolve a tri-state bf16 flag: ``"auto"`` or ``None`` -> the backend
    default (off), ``"on"`` / ``"off"`` (or bools) -> forced. Any other
    string raises ``KeyError``, as the JAX function does."""
    if choice in (None, "auto"):
        return tpu_default_bf16()
    if isinstance(choice, str):
        return {"on": True, "off": False}[choice]
    return bool(choice)


__all__ = ["resolve_bf16", "tpu_default_bf16"]
