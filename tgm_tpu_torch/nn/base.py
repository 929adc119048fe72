"""Encoder protocol (port of ``tgm_tpu/nn/base.py``).

An encoder is a callable with a ``requires`` attribute naming the
hook-produced batch attributes it reads; ``HookManager.validate_requirement``
checks them against the hooks registered under a key.
"""

from __future__ import annotations

from typing import Any, Protocol, Set, runtime_checkable


@runtime_checkable
class EncoderModule(Protocol):
    requires: Set[str]

    def __call__(self, batch: Any, *args: Any, **kwargs: Any) -> Any: ...


__all__ = ["EncoderModule"]
