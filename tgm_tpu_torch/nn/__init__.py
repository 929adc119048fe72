from .decoder.decoders import LinkPredictor
from .encoder.dygformer import (
    DyGFormer,
    FusedSelfAttention,
    MultiHeadDotProductAttention,
    NeighborCooccurrenceEncoder,
    TransformerEncoder,
    dygformer_stack_layers,
)
from .encoder.tgn import (
    GraphAttentionEmbeddingRowwise,
    TGNMemory,
    TGNMemoryState,
    tgn_commit_staged,
    tgn_init_state,
    tgn_store_messages,
)
from .modules.aggregation import Aggregator, ConcatMerge
from .modules.gru import TorchGRUCell
from .modules.time_encoding import Time2Vec

__all__ = [
    "Aggregator",
    "ConcatMerge",
    "DyGFormer",
    "FusedSelfAttention",
    "GraphAttentionEmbeddingRowwise",
    "LinkPredictor",
    "MultiHeadDotProductAttention",
    "NeighborCooccurrenceEncoder",
    "TGNMemory",
    "TGNMemoryState",
    "Time2Vec",
    "TorchGRUCell",
    "TransformerEncoder",
    "dygformer_stack_layers",
    "tgn_commit_staged",
    "tgn_init_state",
    "tgn_store_messages",
]
