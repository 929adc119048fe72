"""Framework-wide constants (own copy of ``tgm_tpu/constants.py``).

The port keeps the JAX package's state layouts so that state tensors compare
element by element: int32 ids/times/edge ids, ``PADDED_NODE_ID`` on padded
slots, and node-indexed state with N+1 rows whose last row is the dump row.
"""

from typing import Final

# Sentinel id used to pad neighbor lists / invalid node slots.
PADDED_NODE_ID: Final[int] = -1

# Timestamp written into padded slots.
PADDED_TIME: Final[int] = 0

# Default cutoff for NDCG@k (TGB node property prediction).
DEFAULT_NDCG_K: Final[int] = 10

# Recipe identifiers.
RECIPE_TGB_LINK_PRED: Final[str] = "tgb-link-pred"

# Metric names of TGB-style evaluation.
METRIC_TGB_LINK_PRED: Final[str] = "mrr"
METRIC_TGB_NODE_PRED: Final[str] = "ndcg"
