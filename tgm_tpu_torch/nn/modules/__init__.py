from .aggregation import (
    Aggregator,
    ConcatMerge,
    LearnableSumMerge,
    MeanEmbdPooling,
    SumEmbdPooling,
)
from .attention import TemporalAttention
from .edgebank import EdgeBankPredictor
from .graph_conv import ChebConv, GCNConv
from .gru import TorchGRUCell
from .mlp_mixer import FeedForwardNet, MLPMixer
from .poptrack import PopTrackPredictor
from .t_comem import tCoMemPredictor
from .time_encoding import Time2Vec

__all__ = [
    "Aggregator",
    "ChebConv",
    "ConcatMerge",
    "EdgeBankPredictor",
    "FeedForwardNet",
    "GCNConv",
    "LearnableSumMerge",
    "MLPMixer",
    "MeanEmbdPooling",
    "PopTrackPredictor",
    "SumEmbdPooling",
    "TemporalAttention",
    "Time2Vec",
    "TorchGRUCell",
    "tCoMemPredictor",
]
