from .ctan import CTAN, CTANMemoryState, ctan_memory_init, ctan_memory_update
from .dygformer import DyGFormer, NeighborCooccurrenceEncoder, TransformerEncoder
from .gclstm import GCLSTM
from .gcn import GCN
from .roland import ROLAND
from .tgat import TGAT, MergeLayer
from .tgcn import TGCN
from .tgn import (
    GraphAttentionEmbedding,
    TGNMemory,
    TGNMemoryState,
    tgn_init_state,
    tgn_store_messages,
)
from .tpnet import (
    RandomProjectionModule,
    RandomProjectionState,
    TPNet,
    rp_init_state,
    rp_update,
)

__all__ = [
    "CTAN",
    "CTANMemoryState",
    "DyGFormer",
    "GCLSTM",
    "GCN",
    "GraphAttentionEmbedding",
    "MergeLayer",
    "NeighborCooccurrenceEncoder",
    "ROLAND",
    "RandomProjectionModule",
    "RandomProjectionState",
    "TGAT",
    "TGCN",
    "TGNMemory",
    "TGNMemoryState",
    "TPNet",
    "TransformerEncoder",
    "ctan_memory_init",
    "ctan_memory_update",
    "rp_init_state",
    "rp_update",
    "tgn_init_state",
    "tgn_store_messages",
]
