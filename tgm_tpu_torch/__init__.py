"""tgm_tpu_torch: the PyTorch/CUDA port of tgm_tpu, for one NVIDIA H100.

The JAX package ``tgm_tpu`` is the reference and stays unchanged; this
package keeps its module layout, names and state layouts. It imports torch
and numpy, never JAX or anything of ``tgm_tpu``. Entry points take a
``device`` (default ``cuda``) and raise without a card; the hand-written CUDA
kernels under ``csrc/`` run on CUDA tensors, their plain PyTorch versions on
CPU tensors.
"""

from .constants import PADDED_NODE_ID
from .core import DGBatch, DGraph
from .data import DGData, DGDataLoader
from .timedelta import TGB_SEQ_TIME_DELTAS, TGB_TIME_DELTAS, TimeDeltaDG

__all__ = [
    "DGBatch",
    "DGData",
    "DGDataLoader",
    "DGraph",
    "PADDED_NODE_ID",
    "TGB_SEQ_TIME_DELTAS",
    "TGB_TIME_DELTAS",
    "TimeDeltaDG",
]
