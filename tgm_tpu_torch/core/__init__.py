from ._storage import (
    DGSliceTracker,
    DGStorage,
    DGStorageArrayBackend,
    DGStorageBackends,
    DGStorageBase,
    get_dg_storage_backend,
    set_dg_storage_backend,
)
from .batch import DGBatch
from .graph import DGraph

__all__ = [
    "DGBatch",
    "DGSliceTracker",
    "DGStorage",
    "DGStorageArrayBackend",
    "DGStorageBackends",
    "DGStorageBase",
    "DGraph",
    "get_dg_storage_backend",
    "set_dg_storage_backend",
]
