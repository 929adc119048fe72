"""TGCN snapshot node property prediction on the port (``examples/nodeproppred/tgcn.py``).

    python -m tgm_tpu_torch.examples.nodeproppred.tgcn [--dataset synthetic]
        [--epochs 1] [--snapshot-ticks 100] [--device cuda] ...

A TGCN cell (embed 64) carries its hidden state H across a split's
snapshots over the static node features; label batches are predicted from
the latest H. The GCN example's harness (``gcn.build``, ``gcn.run``) with
this encoder, step and zero initial state.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ...nn import TGCN
from . import gcn


def make_encoder(args, node_dim: int) -> torch.nn.Module:
    return TGCN(in_channels=node_dim, out_channels=args.embed_dim)


def snapshot_apply(encoder, node_x, H, sbatch):
    H2 = encoder(node_x, sbatch.edge_src, sbatch.edge_dst, None, H, sbatch.edge_valid)
    return H2, H2


def init_H(num_nodes: int, dim: int, device) -> torch.Tensor:
    return torch.zeros((num_nodes, dim), device=device)


HOOKS = dict(make_encoder=make_encoder, snapshot_apply=snapshot_apply, init_H=init_H)


def parse_args(argv: Optional[List[str]] = None):
    return gcn.node_parser("TGCN snapshot nodeproppred").parse_args(argv)


def build(args, data=None):
    return gcn.build(args, data, **HOOKS)


def main(argv: Optional[List[str]] = None):
    return gcn.main(argv, parse=parse_args, **HOOKS)


if __name__ == "__main__":
    main()
