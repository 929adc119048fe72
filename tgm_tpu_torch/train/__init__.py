from .hook_pipeline import hook_epoch
from .programs import (
    bce_with_logits,
    build_dygformer_eval_core,
    build_tgn_hook_cores,
    tgn_eval_commit,
    tgn_train_commit,
)
from .stream import DeviceEdgeStream

__all__ = [
    "DeviceEdgeStream",
    "bce_with_logits",
    "build_dygformer_eval_core",
    "build_tgn_hook_cores",
    "hook_epoch",
    "tgn_eval_commit",
    "tgn_train_commit",
]
