from . import decoder, encoder, modules
from .base import EncoderModule
from .decoder.decoders import GraphPredictor, LinkPredictor, NodePredictor
from .decoder.ncnpred import NCNPredictor
from .encoder.ctan import CTAN, CTANMemoryState, ctan_memory_init, ctan_memory_update
from .encoder.dygformer import (
    DyGFormer,
    FusedSelfAttention,
    MultiHeadDotProductAttention,
    NeighborCooccurrenceEncoder,
    TransformerEncoder,
    dygformer_stack_layers,
)
from .encoder.gclstm import GCLSTM
from .encoder.gcn import GCN
from .encoder.roland import ROLAND
from .encoder.tgat import TGAT, MergeLayer
from .encoder.tgcn import TGCN
from .encoder.tpnet import (
    RandomProjectionModule,
    RandomProjectionState,
    TPNet,
    rp_init_state,
    rp_update,
)
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
from .modules.edgebank import EdgeBankPredictor
from .modules.graph_conv import ChebConv, GCNConv
from .modules.gru import TorchGRUCell
from .modules.mlp_mixer import FeedForwardNet, MLPMixer
from .modules.poptrack import PopTrackPredictor
from .modules.t_comem import tCoMemPredictor
from .modules.time_encoding import Time2Vec

__all__ = [
    "Aggregator",
    "CTAN",
    "CTANMemoryState",
    "ChebConv",
    "ConcatMerge",
    "DyGFormer",
    "EdgeBankPredictor",
    "EncoderModule",
    "FeedForwardNet",
    "FusedSelfAttention",
    "GCLSTM",
    "GCN",
    "GCNConv",
    "GraphAttentionEmbedding",
    "GraphAttentionEmbeddingRowwise",
    "GraphPredictor",
    "LearnableSumMerge",
    "LinkPredictor",
    "MLPMixer",
    "MeanEmbdPooling",
    "MergeLayer",
    "MultiHeadDotProductAttention",
    "NCNPredictor",
    "NeighborCooccurrenceEncoder",
    "NodePredictor",
    "PopTrackPredictor",
    "ROLAND",
    "RandomProjectionModule",
    "RandomProjectionState",
    "SumEmbdPooling",
    "TGAT",
    "TGCN",
    "TGNMeanMemoryState",
    "TGNMemory",
    "TGNMemoryState",
    "TGNPackedState",
    "TPNet",
    "TemporalAttention",
    "Time2Vec",
    "TorchGRUCell",
    "TransformerEncoder",
    "ctan_memory_init",
    "decoder",
    "ctan_memory_update",
    "dygformer_stack_layers",
    "encoder",
    "modules",
    "rp_init_state",
    "rp_update",
    "tCoMemPredictor",
    "tgn_commit_staged",
    "tgn_init_state",
    "tgn_mean_init_state",
    "tgn_mean_store_messages",
    "tgn_pack_state",
    "tgn_store_messages",
    "tgn_store_messages_packed",
    "tgn_unpack_state",
]
