from .dyg_transformer import (
    StackWeights,
    convert_flax_layer,
    stack_weights,
    transformer_stack_fwd,
    transformer_stack_fwd_plain,
)
from .recency_select import (
    gather_edge_feats,
    recency_eid_select,
    recency_eid_select_plain,
    recency_window_select,
    recency_window_select_eid,
    recency_window_select_eid_plain,
    recency_window_select_plain,
)
from .scatter_cells import (
    push_plan_dense,
    recency_push,
    recency_push_plain,
    scatter_cells,
    scatter_cells_plain,
    tgn_store_commit,
    tgn_store_commit_plain,
    tgn_store_scatter_1d,
    tgn_store_scatter_1d_plain,
)
from .segment import segment_max

__all__ = [
    "StackWeights",
    "convert_flax_layer",
    "gather_edge_feats",
    "push_plan_dense",
    "recency_eid_select",
    "recency_eid_select_plain",
    "recency_push",
    "recency_push_plain",
    "recency_window_select",
    "recency_window_select_eid",
    "recency_window_select_eid_plain",
    "recency_window_select_plain",
    "scatter_cells",
    "scatter_cells_plain",
    "segment_max",
    "stack_weights",
    "tgn_store_commit",
    "tgn_store_commit_plain",
    "tgn_store_scatter_1d",
    "tgn_store_scatter_1d_plain",
    "transformer_stack_fwd",
    "transformer_stack_fwd_plain",
]
