"""GCN snapshot link prediction on the port (``examples/linkproppred/gcn.py``).

    python -m tgm_tpu_torch.examples.linkproppred.gcn [--dataset synthetic]
        [--epochs 1] [--snapshot-ticks 100] [--device cuda] ...

Each snapshot's embeddings come from a two-layer GCN (embed 64) over the
static node features (``normal(N, 16)`` from ``--seed`` where the data has
none), with no recurrence; event batches are predicted against the latest
snapshot's embeddings (``_snapshot_common``). The flags and defaults are
the JAX example's, less ``--eager`` (ROADMAP "Not queued"), plus
``--device`` (default ``cuda``). ``build`` and ``run`` split ``main`` so
that a caller can load weights or replace the negative draws in between.
"""

from __future__ import annotations

import argparse
from types import SimpleNamespace
from typing import List, Optional

from ...nn import GCN
from .._snapshot_common import build_context, run, setup_snapshot, snapshot_parser


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    return snapshot_parser("GCN snapshot link prediction").parse_args(argv)


def build(args: argparse.Namespace, data=None, cands=None) -> SimpleNamespace:
    """The example's modules, optimizer and snapshot step (``build_context``)."""
    setup = setup_snapshot(args, data, cands)
    node_x = setup.node_x
    encoder = GCN(node_x.shape[1], args.embed_dim, args.embed_dim, num_layers=2).to(setup.device)

    def snap_apply(rec, sbatch):
        z = encoder(node_x, sbatch.edge_src, sbatch.edge_dst, None, sbatch.edge_valid)
        return z, rec

    return build_context(args, setup, encoder, snap_apply, lambda: None)


def main(argv: Optional[List[str]] = None):
    args = parse_args(argv)
    return run(build(args), args)


if __name__ == "__main__":
    main()
