from .decoder.decoders import LinkPredictor, NodePredictor
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
    GraphAttentionEmbedding,
    GraphAttentionEmbeddingRowwise,
    TGNMeanMemoryState,
    TGNMemory,
    TGNMemoryState,
    TGNPackedState,
    tgn_commit_staged,
    tgn_init_state,
    tgn_mean_init_state,
    tgn_mean_store_messages,
    tgn_pack_state,
    tgn_store_messages,
    tgn_store_messages_packed,
    tgn_unpack_state,
)
from .modules.aggregation import (
    Aggregator,
    ConcatMerge,
    LearnableSumMerge,
    MeanEmbdPooling,
    SumEmbdPooling,
)
from .modules.attention import TemporalAttention
from .modules.gru import TorchGRUCell
from .modules.time_encoding import Time2Vec

__all__ = [
    "Aggregator",
    "ConcatMerge",
    "DyGFormer",
    "FusedSelfAttention",
    "GraphAttentionEmbedding",
    "GraphAttentionEmbeddingRowwise",
    "LearnableSumMerge",
    "LinkPredictor",
    "MeanEmbdPooling",
    "MergeLayer",
    "MultiHeadDotProductAttention",
    "NeighborCooccurrenceEncoder",
    "NodePredictor",
    "SumEmbdPooling",
    "TGAT",
    "TGNMeanMemoryState",
    "TGNMemory",
    "TGNMemoryState",
    "TGNPackedState",
    "TemporalAttention",
    "Time2Vec",
    "TorchGRUCell",
    "TransformerEncoder",
    "dygformer_stack_layers",
    "tgn_commit_staged",
    "tgn_init_state",
    "tgn_mean_init_state",
    "tgn_mean_store_messages",
    "tgn_pack_state",
    "tgn_store_messages",
    "tgn_store_messages_packed",
    "tgn_unpack_state",
]
