"""Persistent-forecast node-property baseline on the port
(``examples/nodeproppred/persistant_forecast.py``).

    python -m tgm_tpu_torch.examples.nodeproppred.persistant_forecast
        [--dataset synthetic] [--bsize 200] [--device cuda] ...

Each labelled node is predicted by its previous label (zeros before its
first), scored by NDCG@10 over the batch's valid labels before the batch's
labels overwrite the table; the table persists across train, val and test,
and each split's value is the mean over its batches with labels. The
table lives on the device: of a node labelled twice in one batch, the last
label is kept, as numpy's assignment keeps it. The flags and defaults are
the JAX example's, plus ``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse
from dataclasses import replace
from typing import Dict, List, Optional

import torch

from ...core.graph import DGraph
from ...data.loader import DGDataLoader
from ...device import resolve_device
from ...eval.metrics import ndcg_at_k
from .._datasets import load_dataset


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Persistent forecast nodeproppred")
    p.add_argument("--dataset", type=str, default="synthetic")
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--bsize", type=int, default=200)
    p.add_argument("--num-classes", type=int, default=10)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def store_last(table: torch.Tensor, nids: torch.Tensor, y: torch.Tensor,
               valid: torch.Tensor) -> None:
    """``table[nids[valid]] = y[valid]``, the last of equal ids winning,
    without a host sync: every other row goes to the dump row ``N``."""
    N = table.shape[0] - 1
    pos = torch.arange(nids.shape[0], device=nids.device)
    safe = torch.where(valid, nids.long(), N)
    last = torch.full((N + 1,), -1, dtype=torch.long, device=nids.device)
    last.scatter_reduce_(0, safe, torch.where(valid, pos, -1), "amax")
    rows = torch.where(valid & (last[safe] == pos), safe, N)
    table.index_put_((rows,), y)


def run(args: argparse.Namespace, data=None) -> Dict[str, float]:
    """Each split's mean NDCG@10; ``data`` replaces the dataset ``args.dataset`` names."""
    dev = resolve_device(args.device)
    if data is None:
        data, _, _ = load_dataset(args.dataset, node_label_classes=args.num_classes)
    N = data.num_nodes
    table = torch.zeros((N + 1, data.node_y.shape[1]), device=dev)  # row N: the dump row
    out = {}
    for name, split in zip(("train", "val", "test"), data.split()):
        scores = []
        split = replace(split, edge_x=None)  # the baseline reads labels alone
        for batch in DGDataLoader(DGraph(split), args.bsize, device=dev):
            if not batch.has("num_node_labels") or batch.num_node_labels == 0:
                continue
            pred = table[batch.node_y_nids.long().clamp(0, N - 1)]
            scores.append(ndcg_at_k(pred, batch.node_y, k=10, row_valid=batch.node_y_valid))
            store_last(table, batch.node_y_nids, batch.node_y, batch.node_y_valid)
        if scores:
            out[name] = float(torch.stack(scores).double().mean())
            print(f"{name}_ndcg={out[name]:.4f}")
    return out


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
