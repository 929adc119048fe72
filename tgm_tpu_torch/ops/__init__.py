from .recency_select import recency_window_select_eid, recency_window_select_eid_plain
from .scatter_cells import (
    scatter_cells,
    scatter_cells_plain,
    tgn_store_scatter_1d,
    tgn_store_scatter_1d_plain,
)
from .segment import segment_max

__all__ = [
    "recency_window_select_eid",
    "recency_window_select_eid_plain",
    "scatter_cells",
    "scatter_cells_plain",
    "segment_max",
    "tgn_store_scatter_1d",
    "tgn_store_scatter_1d_plain",
]
