"""Parallel execution (port of ``tgm_tpu/parallel``): process meshes over
``torch.distributed``, sharding layouts with ``place`` / ``gather``, the
node-sharded TGN and TGAT train steps, and temporal spans (``temporal``)."""

from .mesh import data_model_mesh, initialize_distributed, make_mesh
from .sharding import (
    Sharding,
    batch_shardings,
    gather,
    place,
    replicate_tree,
    replicated,
    row_sharded,
    shard_leading_axis,
    tgat_carry_shardings,
    tgat_carry_shardings_2d,
    tgn_carry_shardings,
    tgn_carry_shardings_2d,
    tp_param_shardings,
)
from .spmd import sharded_tgat_train_step, sharded_tgn_train_step

__all__ = [
    "tp_param_shardings",
    "tgn_carry_shardings_2d",
    "batch_shardings",
    "data_model_mesh",
    "initialize_distributed",
    "make_mesh",
    "replicate_tree",
    "replicated",
    "row_sharded",
    "shard_leading_axis",
    "tgat_carry_shardings",
    "tgat_carry_shardings_2d",
    "tgn_carry_shardings",
    # The port's own names.
    "Sharding",
    "gather",
    "place",
    "sharded_tgat_train_step",
    "sharded_tgn_train_step",
]
