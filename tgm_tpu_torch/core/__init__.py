from .batch import DGBatch
from .graph import DGraph

__all__ = ["DGBatch", "DGraph"]
