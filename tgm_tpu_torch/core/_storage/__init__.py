from .array_backend import DGStorageArrayBackend
from .base import DGSliceTracker

# The array backend is the only storage engine.
DGStorage = DGStorageArrayBackend

__all__ = ["DGSliceTracker", "DGStorage", "DGStorageArrayBackend"]
