from .dg_data import DGData
from .loader import BatchPlan, DGDataLoader
from .split import SplitStrategy, TemporalRatioSplit, TemporalSplit, TGBSplit

__all__ = ["BatchPlan", "DGData", "DGDataLoader", "SplitStrategy", "TemporalRatioSplit",
           "TemporalSplit", "TGBSplit"]
