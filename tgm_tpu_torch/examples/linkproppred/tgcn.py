"""TGCN snapshot link prediction on the port (``examples/linkproppred/tgcn.py``).

    python -m tgm_tpu_torch.examples.linkproppred.tgcn [--dataset synthetic]
        [--epochs 1] [--snapshot-ticks 100] [--device cuda] ...

A TGCN cell (embed 64) carries its hidden state H across snapshots over
the static node features (``normal(N, 16)`` from ``--seed`` where the data
has none); event batches are predicted against the latest H
(``_snapshot_common``). The flags and defaults are the JAX example's, less
``--eager`` (ROADMAP "Not queued"), plus ``--device`` (default ``cuda``).
``build`` and ``run`` split ``main``.
"""

from __future__ import annotations

import argparse
from types import SimpleNamespace
from typing import List, Optional

import torch

from ...nn import TGCN
from .._snapshot_common import build_context, run, setup_snapshot, snapshot_parser


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    return snapshot_parser("TGCN snapshot link prediction").parse_args(argv)


def build(args: argparse.Namespace, data=None, cands=None) -> SimpleNamespace:
    """The example's modules, optimizer and snapshot step (``build_context``)."""
    setup = setup_snapshot(args, data, cands)
    node_x, dev = setup.node_x, setup.device
    encoder = TGCN(in_channels=node_x.shape[1], out_channels=args.embed_dim).to(dev)

    def snap_apply(H, sbatch):
        H2 = encoder(node_x, sbatch.edge_src, sbatch.edge_dst, None, H, sbatch.edge_valid)
        return H2, H2

    return build_context(args, setup, encoder, snap_apply,
                         lambda: torch.zeros((setup.num_nodes, args.embed_dim), device=dev))


def main(argv: Optional[List[str]] = None):
    args = parse_args(argv)
    return run(build(args), args)


if __name__ == "__main__":
    main()
