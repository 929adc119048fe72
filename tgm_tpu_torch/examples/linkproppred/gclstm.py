"""GC-LSTM snapshot link prediction on the port (``examples/linkproppred/gclstm.py``).

    python -m tgm_tpu_torch.examples.linkproppred.gclstm [--dataset synthetic]
        [--epochs 1] [--snapshot-ticks 100] [--K 1] [--device cuda] ...

A GC-LSTM cell (embed 64, Chebyshev order ``--K``) carries (H, C) across
snapshots over the static node features (``normal(N, 16)`` from ``--seed``
where the data has none); event batches are predicted against ReLU(H) of
the latest snapshot (``_snapshot_common``). At the default ``K = 1`` the
cell's convolutions read no edge (``ChebConv``). The flags and defaults
are the JAX example's, less ``--eager`` (ROADMAP "Not queued"), plus
``--device`` (default ``cuda``). ``build`` and ``run`` split ``main``.
"""

from __future__ import annotations

import argparse
from types import SimpleNamespace
from typing import List, Optional

import torch

from ...nn import GCLSTM
from .._snapshot_common import build_context, run, setup_snapshot, snapshot_parser


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = snapshot_parser("GCLSTM snapshot link prediction")
    p.add_argument("--K", type=int, default=1)
    return p.parse_args(argv)


def build(args: argparse.Namespace, data=None, cands=None) -> SimpleNamespace:
    """The example's modules, optimizer and snapshot step (``build_context``)."""
    setup = setup_snapshot(args, data, cands)
    node_x, dev = setup.node_x, setup.device
    encoder = GCLSTM(in_channels=node_x.shape[1], out_channels=args.embed_dim, K=args.K).to(dev)

    def snap_apply(rec, sbatch):
        H, C = rec
        H2, C2 = encoder(node_x, sbatch.edge_src, sbatch.edge_dst, None, H, C, sbatch.edge_valid)
        return torch.relu(H2), (H2, C2)

    def init_rec():
        z0 = torch.zeros((setup.num_nodes, args.embed_dim), device=dev)
        return z0, z0

    return build_context(args, setup, encoder, snap_apply, init_rec)


def main(argv: Optional[List[str]] = None):
    args = parse_args(argv)
    return run(build(args), args)


if __name__ == "__main__":
    main()
