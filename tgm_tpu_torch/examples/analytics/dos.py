"""Density of states on the port (``examples/analytics/dos.py``).

    python -m tgm_tpu_torch.examples.analytics.dos [--dataset synthetic]
        [--seed 1337] [--bsize 200] [--device cuda]

Defines a custom hook, ``SpectralDensityHook``: the eigenvalue histogram
of each batch subgraph's normalized adjacency, an example of the
user-defined hook API. The batches are materialized on ``--device``
(default ``cuda``); the hook reads each batch's edges back to the host and
computes the histogram there with numpy, as the JAX example does, since an
analytics hook is a diagnostic and not on the hot path. Prints the first
five batches' histograms.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from ...core.graph import DGraph
from ...data.loader import DGDataLoader
from ...device import resolve_device
from ...hooks import HookManager, StatelessHook, hook
from ...util import seed_everything
from .._datasets import load_dataset


@hook
class SpectralDensityHook(StatelessHook):
    """Eigenvalue histogram of the batch subgraph's normalized adjacency."""

    _cls_requires = {"edge_src", "edge_dst"}
    _cls_produces = {"spectral_density", "spectral_bins"}

    def __init__(self, num_nodes: int, bins: int = 11, id=None) -> None:
        super().__init__(id=id)
        self.num_nodes = num_nodes
        self.bins = bins

    def apply(self, state, batch):
        src = batch.edge_src.cpu().numpy()
        dst = batch.edge_dst.cpu().numpy()
        valid = (np.ones(len(src), bool) if batch.edge_valid is None
                 else batch.edge_valid.cpu().numpy())
        nodes = np.unique(np.concatenate([src[valid], dst[valid]]))
        if len(nodes) == 0:
            return state, batch
        remap = {n: i for i, n in enumerate(nodes.tolist())}
        A = np.zeros((len(nodes), len(nodes)))
        for s, d in zip(src[valid], dst[valid]):
            A[remap[s], remap[d]] = A[remap[d], remap[s]] = 1.0
        deg = np.maximum(A.sum(1), 1.0)
        D = np.diag(deg**-0.5)
        evals = np.linalg.eigvalsh(D @ A @ D)
        hist, edges = np.histogram(evals, bins=self.bins, range=(-1, 1), density=True)
        self.add_batch_attribute(batch, "spectral_density", hist)
        self.add_batch_attribute(batch, "spectral_bins", edges)
        return state, batch


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Spectral density (DOS) example")
    p.add_argument("--dataset", type=str, default="synthetic")
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--bsize", type=int, default=200)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> List[np.ndarray]:
    """Print and return the first five batches' histograms."""
    args = parse_args(argv)
    seed_everything(args.seed)
    device = resolve_device(args.device)

    data, _, _ = load_dataset(args.dataset)
    dg = DGraph(data)
    hm = HookManager(keys=["analytics"])
    hm.register("analytics", SpectralDensityHook(num_nodes=data.num_nodes))

    out = []
    with hm.activate("analytics"):
        for i, batch in enumerate(DGDataLoader(dg, args.bsize, hook_manager=hm, device=device)):
            d = np.round(batch.spectral_density, 2)
            print(f"batch={i} dos={d.tolist()}")
            out.append(batch.spectral_density)
            if i >= 4:
                break
    return out


if __name__ == "__main__":
    main()
