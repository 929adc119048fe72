"""TGCN graph property prediction over snapshots on the port (``examples/graphproppred/tgcn.py``).

    python -m tgm_tpu_torch.examples.graphproppred.tgcn [--dataset synthetic]
        [--epochs 10] [--snapshot-ticks 200] [--device cuda] ...

The GCN graph example's snapshots, targets and split (``gcn.graph_setup``),
with a TGCN cell (embed 32) carrying its hidden state H across snapshots
and a ``GraphPredictor`` pooling H. H starts at zero each epoch; a train
step differentiates through one TGCN step (encoder and head train, by
Adam) and carries H on detached; the test predictions carry H on from
the end of training.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, List, Optional

import torch

from ...nn import TGCN, GraphPredictor
from ...train.programs import zero_every_grad
from .gcn import graph_parser, graph_setup, report, stack


def parse_args(argv: Optional[List[str]] = None):
    return graph_parser("TGCN graphproppred").parse_args(argv)


def build(args, data=None) -> SimpleNamespace:
    """``graph_setup``, the TGCN and head, Adam over both, ``init_H()`` and
    the steps: ``forward(H, batch) -> (pred, H)``, ``train_step(H, batch,
    y) -> (H, loss)`` and ``predict(H, batch) -> (pred, H)`` (``forward``
    without autograd)."""
    s = graph_setup(args, data)
    encoder = TGCN(in_channels=s.node_x.shape[1], out_channels=args.embed_dim).to(s.device)
    head = GraphPredictor(args.embed_dim, 1).to(s.device)
    opt = torch.optim.Adam([*encoder.parameters(), *head.parameters()], lr=args.lr)

    def forward(H, batch):
        H2 = encoder(s.node_x, batch.edge_src, batch.edge_dst, None, H, batch.edge_valid)
        return head(H2)[0], H2

    def train_step(H, batch, y):
        zero_every_grad(opt)
        pred, H2 = forward(H, batch)
        loss = (pred - y) ** 2
        loss.backward()
        opt.step()
        return H2.detach(), loss.detach()

    predict = torch.no_grad()(forward)
    return SimpleNamespace(**vars(s), encoder=encoder, head=head, opt=opt,
                           forward=forward, train_step=train_step,
                           predict=predict,
                           init_H=lambda: torch.zeros((s.num_nodes, args.embed_dim),
                                                      device=s.device))


def run(ctx: SimpleNamespace, args) -> Dict[str, Any]:
    """As the GCN example's ``run``, the state carried as described above."""
    out: Dict[str, Any] = {"losses": [], "train_mse": [], "test_mse": [], "preds": []}
    n = ctx.n_train
    for epoch in range(args.epochs):
        H, losses, preds = ctx.init_H(), [], []
        for i, b in enumerate(ctx.snapshots[:n]):
            H, loss = ctx.train_step(H, b, ctx.targets_d[i])
            losses.append(loss)
        for b in ctx.snapshots[n:]:
            pred, H = ctx.predict(H, b)
            preds.append(pred)
        report(out, epoch, stack(losses), stack(preds), ctx)
    return out


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    return run(build(args), args)


if __name__ == "__main__":
    main()
