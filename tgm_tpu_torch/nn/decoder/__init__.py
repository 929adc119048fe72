from .decoders import GraphPredictor, LinkPredictor, NodePredictor
from .ncnpred import NCNPredictor

__all__ = ["GraphPredictor", "LinkPredictor", "NCNPredictor", "NodePredictor"]
