"""Storage backend registry (port of ``tgm_tpu/core/_storage/__init__.py``).

``get_dg_storage_backend`` and ``set_dg_storage_backend`` select the engine
by class or by name; ``DGStorage(data)`` builds the selected one. The array
backend is the only engine.
"""

from __future__ import annotations

from typing import Dict, Type, Union

from .array_backend import DGStorageArrayBackend
from .base import DGSliceTracker, DGStorageBase

DGStorageBackends: Dict[str, Type[DGStorageBase]] = {
    "ArrayBackend": DGStorageArrayBackend,
}

_current_backend: Type[DGStorageBase] = DGStorageArrayBackend


def get_dg_storage_backend() -> Type[DGStorageBase]:
    return _current_backend


def set_dg_storage_backend(backend: Union[str, Type[DGStorageBase]]) -> None:
    global _current_backend
    if isinstance(backend, str):
        if backend not in DGStorageBackends:
            raise ValueError(
                f"Unknown storage backend {backend!r}; expected one of {list(DGStorageBackends)}"
            )
        _current_backend = DGStorageBackends[backend]
    elif isinstance(backend, type) and issubclass(backend, DGStorageBase):
        _current_backend = backend
    else:
        raise ValueError(f"Invalid storage backend: {backend!r}")


def DGStorage(data) -> DGStorageBase:
    """Construct a storage engine with the currently selected backend."""
    return _current_backend(data)


__all__ = [
    "DGSliceTracker",
    "DGStorage",
    "DGStorageArrayBackend",
    "DGStorageBackends",
    "DGStorageBase",
    "get_dg_storage_backend",
    "set_dg_storage_backend",
]
