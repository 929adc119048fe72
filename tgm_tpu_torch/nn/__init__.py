from .decoder.decoders import LinkPredictor
from .encoder.tgn import (
    GraphAttentionEmbeddingRowwise,
    TGNMemory,
    TGNMemoryState,
    tgn_init_state,
    tgn_store_messages,
)
from .modules.aggregation import Aggregator, ConcatMerge
from .modules.gru import TorchGRUCell
from .modules.time_encoding import Time2Vec

__all__ = [
    "Aggregator",
    "ConcatMerge",
    "GraphAttentionEmbeddingRowwise",
    "LinkPredictor",
    "TGNMemory",
    "TGNMemoryState",
    "Time2Vec",
    "TorchGRUCell",
    "tgn_init_state",
    "tgn_store_messages",
]
