from .decoder.decoders import LinkPredictor
from .encoder.dygformer import (
    DyGFormer,
    FusedSelfAttention,
    MultiHeadDotProductAttention,
    NeighborCooccurrenceEncoder,
    TransformerEncoder,
    dygformer_stack_layers,
)
from .encoder.tgat import TGAT, MergeLayer
from .encoder.tgn import (
    GraphAttentionEmbeddingRowwise,
    TGNMemory,
    TGNMemoryState,
    tgn_commit_staged,
    tgn_init_state,
    tgn_store_messages,
)
from .modules.aggregation import Aggregator, ConcatMerge
from .modules.attention import TemporalAttention
from .modules.gru import TorchGRUCell
from .modules.time_encoding import Time2Vec

__all__ = [
    "Aggregator",
    "ConcatMerge",
    "DyGFormer",
    "FusedSelfAttention",
    "GraphAttentionEmbeddingRowwise",
    "LinkPredictor",
    "MergeLayer",
    "MultiHeadDotProductAttention",
    "NeighborCooccurrenceEncoder",
    "TGAT",
    "TGNMemory",
    "TGNMemoryState",
    "TemporalAttention",
    "Time2Vec",
    "TorchGRUCell",
    "TransformerEncoder",
    "dygformer_stack_layers",
    "tgn_commit_staged",
    "tgn_init_state",
    "tgn_store_messages",
]
