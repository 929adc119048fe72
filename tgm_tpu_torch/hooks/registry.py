"""Global hook registry (port of ``tgm_tpu/hooks/registry.py``)."""

from __future__ import annotations

from typing import List

_HOOK_REGISTRY: List[type] = []


def hook(cls: type) -> type:
    """Class decorator registering a hook into the global registry."""
    _HOOK_REGISTRY.append(cls)
    return cls


def list_hooks() -> List[type]:
    return list(_HOOK_REGISTRY)
