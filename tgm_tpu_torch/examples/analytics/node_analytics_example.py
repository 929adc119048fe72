"""Node analytics on the port (``examples/analytics/node_analytics_example.py``).

    python -m tgm_tpu_torch.examples.analytics.node_analytics_example
        [--dataset synthetic] [--seed 1337] [--bsize 200]
        [--tracked 0 1 2 3] [--device cuda]

Streams the whole dataset's batches through ``NodeAnalyticsHook`` on
``--device`` (default ``cuda``), tracking the ``--tracked`` nodes, and
prints the first ten batches' tracked degrees, new-node count, edge
novelty and density.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional

import numpy as np

from ...core.graph import DGraph
from ...data.loader import DGDataLoader
from ...device import resolve_device
from ...hooks import HookManager, NodeAnalyticsHook
from ...util import seed_everything
from .._datasets import load_dataset


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Node analytics example")
    p.add_argument("--dataset", type=str, default="synthetic")
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--bsize", type=int, default=200)
    p.add_argument("--tracked", type=int, nargs="+", default=[0, 1, 2, 3])
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> List[Dict[str, Any]]:
    """Print and return the first ten batches' statistics."""
    args = parse_args(argv)
    seed_everything(args.seed)
    device = resolve_device(args.device)

    data, _, _ = load_dataset(args.dataset)
    dg = DGraph(data)
    hm = HookManager(keys=["analytics"])
    hm.register("analytics", NodeAnalyticsHook(np.asarray(args.tracked),
                                               num_nodes=data.num_nodes, device=device))

    rows = []
    with hm.activate("analytics"):
        for i, batch in enumerate(DGDataLoader(dg, args.bsize, hook_manager=hm, device=device)):
            ns, ms, es = batch.node_stats, batch.node_macro_stats, batch.edge_stats
            row = dict(tracked_degrees=ns["degree"].tolist(),
                       new_nodes=int(ms["new_node_count"]),
                       edge_novelty=float(es["edge_novelty"]),
                       density=float(es["edge_density"]))
            print(f"batch={i} tracked_degrees={row['tracked_degrees']} "
                  f"new_nodes={row['new_nodes']} edge_novelty={row['edge_novelty']:.2f} "
                  f"density={row['density']:.4f}")
            rows.append(row)
            if i >= 9:
                break
    return rows


if __name__ == "__main__":
    main()
