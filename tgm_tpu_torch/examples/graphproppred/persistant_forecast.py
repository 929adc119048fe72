"""Persistent-forecast graph-property baseline on the port
(``examples/graphproppred/persistant_forecast.py``).

    python -m tgm_tpu_torch.examples.graphproppred.persistant_forecast
        [--dataset synthetic] [--snapshot-ticks 200] [--device cuda] ...

Each snapshot's target (its edge count over the largest, as in the GCN
graph example) is predicted by the previous snapshot's; the MSE over every
snapshot after the first, in float64 on the device from the snapshots' own
edge masks. The flags and defaults are the JAX example's, plus
``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse
from dataclasses import replace
from typing import Dict, List, Optional

import torch

from ...core.graph import DGraph
from ...data.loader import DGDataLoader
from ...device import resolve_device
from ...eval.metrics import mse
from ...timedelta import TimeDeltaDG
from .._datasets import load_dataset


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Persistent forecast graphproppred")
    p.add_argument("--dataset", type=str, default="synthetic")
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--snapshot-ticks", type=int, default=200)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def run(args: argparse.Namespace, data=None) -> Dict[str, float]:
    """The test MSE and the snapshot count; ``data`` replaces the dataset
    ``args.dataset`` names."""
    dev = resolve_device(args.device)
    if data is None:
        data, _, _ = load_dataset(args.dataset)
    coarse = replace(data, edge_x=None).discretize(TimeDeltaDG("s", args.snapshot_ticks))
    loader = DGDataLoader(DGraph(coarse), args.snapshot_ticks, batch_unit="s",
                          materialize_features=False, device=dev)
    counts = torch.stack([b.edge_valid.sum(dtype=torch.float64) for b in loader])
    targets = counts / counts.max().clamp_min(1.0)
    out = {"test_mse": float(mse(targets[:-1], targets[1:])), "snapshots": len(targets)}
    print(f"test_mse={out['test_mse']:.5f} snapshots={out['snapshots']}")
    return out


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
