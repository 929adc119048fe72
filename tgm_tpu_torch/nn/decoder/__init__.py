from .ncnpred import NCNPredictor

__all__ = ["NCNPredictor"]
