"""Batch analytics on the port (``examples/analytics/batch_analytics_example.py``).

    python -m tgm_tpu_torch.examples.analytics.batch_analytics_example
        [--dataset synthetic] [--seed 1337] [--bsize 200] [--device cuda]

Streams the whole dataset's batches through ``BatchAnalyticsHook`` on
``--device`` (default ``cuda``) and prints the first ten batches' counts.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

from ...core.graph import DGraph
from ...data.loader import DGDataLoader
from ...device import resolve_device
from ...hooks import BatchAnalyticsHook, HookManager
from ...util import seed_everything
from .._datasets import load_dataset


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Batch analytics example")
    p.add_argument("--dataset", type=str, default="synthetic")
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--bsize", type=int, default=200)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> List[Dict[str, float]]:
    """Print and return the first ten batches' statistics."""
    args = parse_args(argv)
    seed_everything(args.seed)
    device = resolve_device(args.device)

    data, _, _ = load_dataset(args.dataset)
    dg = DGraph(data)
    hm = HookManager(keys=["analytics"])
    hm.register("analytics", BatchAnalyticsHook())

    rows = []
    with hm.activate("analytics"):
        for i, batch in enumerate(DGDataLoader(dg, args.bsize, hook_manager=hm, device=device)):
            row = dict(edges=int(batch.num_edge_events),
                       unique_ts=int(batch.num_unique_timestamps),
                       unique_nodes=int(batch.num_unique_nodes),
                       avg_degree=float(batch.avg_degree),
                       repeated_edges=int(batch.num_repeated_edge_events))
            print(f"batch={i} edges={row['edges']} unique_ts={row['unique_ts']} "
                  f"unique_nodes={row['unique_nodes']} avg_degree={row['avg_degree']:.2f} "
                  f"repeated_edges={row['repeated_edges']}")
            rows.append(row)
            if i >= 9:
                break
    return rows


if __name__ == "__main__":
    main()
