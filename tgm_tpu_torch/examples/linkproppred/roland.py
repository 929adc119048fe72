"""ROLAND snapshot link prediction on the port (``examples/linkproppred/roland.py``).

    python -m tgm_tpu_torch.examples.linkproppred.roland [--dataset synthetic]
        [--epochs 1] [--snapshot-ticks 100] [--update learnable] [--tau 0.5]
        [--device cuda] ...

A two-layer GCN (embed 64) whose layer outputs are merged with the
previous snapshot's by ``--update`` (moving, learnable, gru, mlp, or fixed
at ``--tau``), over the static node features (``normal(N, 16)`` from
``--seed`` where the data has none); event batches are predicted against
the latest merged embeddings (``_snapshot_common``). ``moving`` weighs by
the previous and current snapshots' edge counts, carried as device tensors
(1.0 before the first). The flags and defaults are the JAX example's, less
``--eager`` (ROADMAP "Not queued"), plus ``--device`` (default ``cuda``).
``build`` and ``run`` split ``main``.
"""

from __future__ import annotations

import argparse
from types import SimpleNamespace
from typing import List, Optional

import torch

from ...nn import ROLAND
from .._snapshot_common import build_context, run, setup_snapshot, snapshot_parser


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = snapshot_parser("ROLAND snapshot link prediction")
    p.add_argument("--update", type=str, default="learnable",
                   choices=["moving", "learnable", "gru", "mlp", "fixed"])
    p.add_argument("--tau", type=float, default=0.5)
    return p.parse_args(argv)


def build(args: argparse.Namespace, data=None, cands=None) -> SimpleNamespace:
    """The example's modules, optimizer and snapshot step (``build_context``)."""
    setup = setup_snapshot(args, data, cands)
    node_x, dev = setup.node_x, setup.device
    encoder = ROLAND(input_channel=node_x.shape[1], out_channel=args.embed_dim,
                     num_nodes=setup.num_nodes,
                     update=None if args.update == "fixed" else args.update,
                     tau0=args.tau).to(dev)

    def snap_apply(rec, sbatch):
        prev_embs, n_prev = rec
        n_cur = sbatch.edge_valid.float().sum()
        z, embs = encoder(node_x, sbatch.edge_src, sbatch.edge_dst,
                          previous_embeddings=prev_embs, num_current_edges=n_cur,
                          num_previous_edges=n_prev, edge_valid=sbatch.edge_valid)
        return z, (embs, n_cur)

    def init_rec():
        return encoder.init_embeddings(dev), torch.ones((), device=dev)

    return build_context(args, setup, encoder, snap_apply, init_rec)


def main(argv: Optional[List[str]] = None):
    args = parse_args(argv)
    return run(build(args), args)


if __name__ == "__main__":
    main()
