"""GC-LSTM snapshot node property prediction on the port (``examples/nodeproppred/gclstm.py``).

    python -m tgm_tpu_torch.examples.nodeproppred.gclstm [--dataset synthetic]
        [--epochs 1] [--snapshot-ticks 100] [--K 1] [--device cuda] ...

A GC-LSTM cell (embed 64, Chebyshev order ``--K``) carries (H, C) across a
split's snapshots over the static node features; label batches are
predicted from ReLU(H) of the latest snapshot. At the default ``K = 1``
(the JAX example's fixed order) the cell's convolutions read no edge. The
GCN example's harness (``gcn.build``, ``gcn.run``) with this encoder, step
and zero initial state; ``--K`` is the port's addition.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ...nn import GCLSTM
from . import gcn


def make_encoder(args, node_dim: int) -> torch.nn.Module:
    return GCLSTM(in_channels=node_dim, out_channels=args.embed_dim, K=args.K)


def snapshot_apply(encoder, node_x, HC, sbatch):
    H, C = HC
    H2, C2 = encoder(node_x, sbatch.edge_src, sbatch.edge_dst, None, H, C, sbatch.edge_valid)
    return torch.relu(H2), (H2, C2)


def init_H(num_nodes: int, dim: int, device):
    z0 = torch.zeros((num_nodes, dim), device=device)
    return z0, z0


HOOKS = dict(make_encoder=make_encoder, snapshot_apply=snapshot_apply, init_H=init_H)


def parse_args(argv: Optional[List[str]] = None):
    p = gcn.node_parser("GCLSTM snapshot nodeproppred")
    p.add_argument("--K", type=int, default=1)
    return p.parse_args(argv)


def build(args, data=None):
    return gcn.build(args, data, **HOOKS)


def main(argv: Optional[List[str]] = None):
    return gcn.main(argv, parse=parse_args, **HOOKS)


if __name__ == "__main__":
    main()
