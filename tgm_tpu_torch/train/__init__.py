from .checkpoint import CheckpointManager, restore_checkpoint, save_checkpoint
from .chunked import ChunkedEdgeStream, chunked_hook_epoch
from .epoch import jit_scan_epoch, scan_epoch
from .hook_pipeline import hook_epoch, scanned_hook_epoch
from .programs import (
    bce_with_logits,
    build_local_edges,
    build_dygformer_eval_core,
    build_dygformer_train_core,
    build_tgat_eval_core,
    build_dygformer_node_cores,
    build_tgat_node_cores,
    build_tgat_train_core,
    build_tgn_hook_cores,
    build_tgn_node_cores,
    build_tpnet_link_cores,
    build_tpnet_node_cores,
    tgn_eval_commit,
    tgn_train_commit,
)
from .snapshot import merged_snapshot_schedule, plan_edge_max_times, scanned_snapshot_epoch
from .stream import DeviceEdgeStream, DeviceEventStream
from .tgat_pipeline import TGATCarry, TGATPipeline, build_aug_table
from .tgn_pipeline import TGNCarry, TGNPipeline

__all__ = [
    "CheckpointManager",
    "ChunkedEdgeStream",
    "DeviceEdgeStream",
    "DeviceEventStream",
    "TGATCarry",
    "TGATPipeline",
    "TGNCarry",
    "TGNPipeline",
    "bce_with_logits",
    "build_aug_table",
    "build_local_edges",
    "build_dygformer_eval_core",
    "build_dygformer_train_core",
    "build_tgat_eval_core",
    "build_dygformer_node_cores",
    "build_tgat_node_cores",
    "build_tgat_train_core",
    "build_tgn_hook_cores",
    "build_tgn_node_cores",
    "build_tpnet_link_cores",
    "build_tpnet_node_cores",
    "chunked_hook_epoch",
    "hook_epoch",
    "jit_scan_epoch",
    "merged_snapshot_schedule",
    "plan_edge_max_times",
    "restore_checkpoint",
    "save_checkpoint",
    "scan_epoch",
    "scanned_hook_epoch",
    "scanned_snapshot_epoch",
    "tgn_eval_commit",
    "tgn_train_commit",
]
