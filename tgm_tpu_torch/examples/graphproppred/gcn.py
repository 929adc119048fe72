"""GCN graph property prediction over snapshots on the port (``examples/graphproppred/gcn.py``).

    python -m tgm_tpu_torch.examples.graphproppred.gcn [--dataset synthetic]
        [--epochs 10] [--snapshot-ticks 200] [--device cuda] ...

The stream is discretized into ``--snapshot-ticks`` windows; each
non-empty window is one snapshot graph (``materialize_features=False``).
A snapshot's target is the next snapshot's edge count over the largest
count (float64 on the host, as numpy gives it; float32 on the device, as
JAX's ``jnp.asarray`` gives it); the last snapshot has none. The first 70%
of the snapshots train, the rest test. A two-layer GCN (embed 32) over the
static node features (``normal(N, 8)`` from ``--seed`` where the data has
none) and a ``GraphPredictor`` (mean pooling over every node) regress the
target with squared error; both train, by Adam, one snapshot a step. The
test MSE is taken on the host against the float64 targets, as in JAX.

The flags and defaults are the JAX example's, plus ``--device`` (default
``cuda``). ``build`` and ``run`` split ``main`` so that a caller can load
weights in between; ``graph_setup`` and ``graph_parser`` serve the TGCN
example too.
"""

from __future__ import annotations

import argparse
from dataclasses import replace
from types import SimpleNamespace
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ...core.graph import DGraph
from ...data.loader import DGDataLoader
from ...device import resolve_device
from ...nn import GCN, GraphPredictor
from ...timedelta import TimeDeltaDG
from ...train.programs import zero_every_grad
from .._datasets import load_dataset

STATIC_DIM = 8  # static node features drawn where the data has none
TRAIN_SHARE = 0.7


def graph_parser(description: str) -> argparse.ArgumentParser:
    """The JAX graph examples' flags and defaults, plus ``--device``."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--dataset", type=str, default="synthetic")
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--embed-dim", type=int, default=32)
    p.add_argument("--snapshot-ticks", type=int, default=200)
    p.add_argument("--device", type=str, default="cuda")
    return p


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    return graph_parser("GCN graphproppred").parse_args(argv)


def graph_setup(args, data=None) -> SimpleNamespace:
    """The snapshots, their targets and the train count, and the static
    node features, on ``args.device``."""
    dev = resolve_device(args.device)
    torch.manual_seed(args.seed)
    if data is None:
        data, _, _ = load_dataset(args.dataset)
    if data.static_node_x is None:
        rng = np.random.default_rng(args.seed)
        data.static_node_x = rng.normal(size=(data.num_nodes, STATIC_DIM)).astype(np.float32)
    coarse = replace(data, edge_x=None).discretize(TimeDeltaDG("s", args.snapshot_ticks))
    loader = DGDataLoader(DGraph(coarse), args.snapshot_ticks, batch_unit="s",
                          materialize_features=False, device=dev)
    snapshots = list(loader)
    counts = loader.plan().edge_counts[loader.nonempty()].astype(np.float64)  # on the host
    targets = counts[1:] / max(counts.max(), 1.0)
    return SimpleNamespace(device=dev, data=data, num_nodes=data.num_nodes,
                           node_x=torch.as_tensor(data.static_node_x, device=dev),
                           snapshots=snapshots[:-1], targets=targets,
                           targets_d=torch.as_tensor(targets, dtype=torch.float32, device=dev),
                           n_train=int((len(snapshots) - 1) * TRAIN_SHARE))


def build(args: argparse.Namespace, data=None) -> SimpleNamespace:
    """``graph_setup``, the GCN and head, Adam over both, and the steps:
    ``forward(batch) -> pred``, ``train_step(batch, y) -> loss`` and
    ``predict(batch) -> pred`` (``forward`` without autograd)."""
    s = graph_setup(args, data)
    encoder = GCN(s.node_x.shape[1], args.embed_dim, args.embed_dim, num_layers=2).to(s.device)
    head = GraphPredictor(args.embed_dim, 1).to(s.device)
    opt = torch.optim.Adam([*encoder.parameters(), *head.parameters()], lr=args.lr)

    def forward(batch):
        z = encoder(s.node_x, batch.edge_src, batch.edge_dst, None, batch.edge_valid)
        return head(z)[0]

    def train_step(batch, y):
        zero_every_grad(opt)
        loss = (forward(batch) - y) ** 2
        loss.backward()
        opt.step()
        return loss.detach()

    predict = torch.no_grad()(forward)
    return SimpleNamespace(**vars(s), encoder=encoder, head=head, opt=opt,
                           forward=forward, train_step=train_step,
                           predict=predict)


def stack(xs: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack(xs) if xs else torch.zeros(0)


def report(out: Dict[str, Any], epoch: int, losses: torch.Tensor, preds: torch.Tensor,
           ctx: SimpleNamespace) -> None:
    """One epoch's train MSE (the mean loss) and test MSE, on the host."""
    losses = losses.cpu().numpy().astype(np.float64)
    preds = preds.cpu().numpy().astype(np.float64)
    train_mse = float(losses.sum()) / max(ctx.n_train, 1)
    test_mse = float(np.mean((preds - ctx.targets[ctx.n_train:]) ** 2))
    out["losses"].append(losses.tolist())
    out["train_mse"].append(train_mse)
    out["test_mse"].append(test_mse)
    out["preds"].append(preds.tolist())
    print(f"epoch={epoch} train_mse={train_mse:.5f} test_mse={test_mse:.5f}")


def run(ctx: SimpleNamespace, args: argparse.Namespace) -> Dict[str, Any]:
    """``args.epochs`` epochs: each trains over the train snapshots in
    order, then predicts every test snapshot. Returns each epoch's
    per-step losses, train and test MSE and test predictions."""
    out: Dict[str, Any] = {"losses": [], "train_mse": [], "test_mse": [], "preds": []}
    n = ctx.n_train
    for epoch in range(args.epochs):
        losses = [ctx.train_step(b, ctx.targets_d[i]) for i, b in enumerate(ctx.snapshots[:n])]
        preds = [ctx.predict(b) for b in ctx.snapshots[n:]]
        report(out, epoch, stack(losses), stack(preds), ctx)
    return out


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    return run(build(args), args)


if __name__ == "__main__":
    main()
