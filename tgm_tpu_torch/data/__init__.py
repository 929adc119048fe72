from .dg_data import DGData
from .split import SplitStrategy, TemporalRatioSplit, TemporalSplit, TGBSplit

__all__ = ["DGData", "SplitStrategy", "TemporalRatioSplit", "TemporalSplit", "TGBSplit"]
