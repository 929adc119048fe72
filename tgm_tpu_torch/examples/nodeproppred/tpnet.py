"""TPNet node property prediction on the port (``examples/nodeproppred/tpnet.py``).

    python -m tgm_tpu_torch.examples.nodeproppred.tpnet [--dataset synthetic]
        [--epochs 1] [--n-nbrs 7] [--device cuda] ...

The stream carries node-label events (``--num-classes`` classes); static
node features are ``normal(N, 8)`` from ``--seed`` where the data has none.
One hook set serves every split: the feature-layout recency hook seeded by
the label nodes at their label times. TPNet (one mixer block, random
projections of 2 layers and ``min(64, N)`` columns, decay 1e-6) pairs each
label node with itself; a ``NodePredictor`` reads its embedding. Per
epoch the RP state starts anew from its initial draw; the train split
runs through the ``DGDataLoader`` and ``train_core`` (soft-label
cross-entropy, Adam, ``rp_update``), val through ``eval_core`` (NDCG@10,
``rp_update``); the hooks reset between epochs (not after the last), and
test follows val on the same states. As in JAX, a batch that carries no
label fields is skipped whole, its ``rp_update`` included; but the loader
pads a batch without labels (``node_y_valid`` all False) instead, so such
a batch takes a step with zero loss and an ``rp_update`` (ROADMAP fault
19). Each reported value is the mean over the batches that ran.

The flags and defaults are the JAX example's, plus ``--device`` (default
``cuda``). ``build`` and ``run`` split ``main`` so that a caller can load
weights or replace the RP state's initial draw in between.
"""

from __future__ import annotations

import argparse
import time
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ...core.graph import DGraph
from ...data.loader import DGDataLoader
from ...device import resolve_device
from ...hooks import HookManager, RecencyNeighborHook
from ...nn import NodePredictor, RandomProjectionModule, TPNet
from ...train import build_tpnet_node_cores
from .._datasets import load_dataset


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="TPNet nodeproppred")
    p.add_argument("--dataset", type=str, default="synthetic")
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--bsize", type=int, default=200)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--n-nbrs", type=int, default=7)
    p.add_argument("--time-dim", type=int, default=32)
    p.add_argument("--embed-dim", type=int, default=64)
    p.add_argument("--num-classes", type=int, default=10)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def build(args: argparse.Namespace, data=None) -> SimpleNamespace:
    """The example's data, hooks, modules, optimizer, cores, dropout
    generator and initial RP state (``rp_state0``) on ``args.device``;
    ``data`` replaces the dataset ``args.dataset`` names."""
    dev = resolve_device(args.device)
    torch.manual_seed(args.seed)
    if data is None:
        data, _, _ = load_dataset(args.dataset, node_label_classes=args.num_classes)
    if data.static_node_x is None:
        rng = np.random.default_rng(args.seed)
        data.static_node_x = rng.normal(size=(data.num_nodes, 8)).astype(np.float32)
    num_nodes = data.num_nodes
    node_x = torch.as_tensor(data.static_node_x, device=dev)
    dgs = [DGraph(s) for s in data.split()]
    edge_dim = dgs[0].edge_x_dim or 0

    hm = HookManager(keys=["all"])
    recency = RecencyNeighborHook(num_nodes, [args.n_nbrs], ["node_y_nids"], ["node_y_time"],
                                  edge_dim=edge_dim, device=dev)
    hm.register_shared(recency)
    rp = RandomProjectionModule(num_nodes=num_nodes, num_layer=2, time_decay_weight=1e-6,
                                use_matrix=False, enforce_dim=min(64, num_nodes))
    encoder = TPNet(node_feat_dim=node_x.shape[1], edge_x_dim=edge_dim,
                    time_feat_dim=args.time_dim, output_dim=args.embed_dim,
                    num_neighbors=args.n_nbrs, num_layers=1, dropout=args.dropout,
                    random_projections=rp).to(dev)
    decoder = NodePredictor(in_dim=args.embed_dim, out_dim=data.node_y.shape[1]).to(dev)
    opt = torch.optim.Adam([*encoder.parameters(), *decoder.parameters()], lr=args.lr)
    train_core, eval_core = build_tpnet_node_cores(encoder, decoder, opt, node_x)
    rp_state0 = rp.init_state(torch.Generator(device=dev).manual_seed(args.seed))
    return SimpleNamespace(device=dev, data=data, dgs=dgs, hm=hm, recency=recency, rp=rp,
                           node_x=node_x, encoder=encoder, decoder=decoder, opt=opt,
                           train_core=train_core, eval_core=eval_core, rp_state0=rp_state0,
                           rp_state=rp_state0,
                           generator=torch.Generator(device=dev).manual_seed(args.seed))


def run_split(ctx: SimpleNamespace, args: argparse.Namespace, split: int,
              core: str) -> torch.Tensor:
    """Split ``split`` through the hooks and ``core`` ("train" or "eval") on
    the batches that carry label fields; returns each one's loss or NDCG."""
    vals = []
    with ctx.hm.activate("all"):
        for batch in DGDataLoader(ctx.dgs[split], args.bsize, hook_manager=ctx.hm,
                                  device=ctx.device):
            if not batch.has("node_y_nids"):
                continue
            if core == "train":
                (ctx.generator, ctx.rp_state), v = ctx.train_core(
                    (ctx.generator, ctx.rp_state), batch)
            else:
                ctx.rp_state, v = ctx.eval_core(ctx.rp_state, batch)
            vals.append(v)
    return torch.stack(vals) if vals else torch.zeros(0)


def _mean(vals: torch.Tensor) -> float:
    return float(vals.mean()) if vals.numel() else 0.0


def run(ctx: SimpleNamespace, args: argparse.Namespace,
        on_epoch_end: Optional[Callable[[int], None]] = None) -> Dict[str, list]:
    """The example's epochs and test; returns each epoch's per-batch losses
    and mean loss, the val and test NDCG. ``on_epoch_end(e)`` runs after
    epoch ``e``'s val, before the reset."""
    out = {"losses": [], "loss": [], "val_ndcg": []}
    n_labels = ctx.dgs[0].num_node_labels
    for e in range(args.epochs):
        ctx.rp_state = ctx.rp.reload_random_projections(ctx.rp_state0)
        t0 = time.perf_counter()
        losses = run_split(ctx, args, 0, "train")
        loss = _mean(losses)  # waits for the card
        dt = time.perf_counter() - t0
        val = _mean(run_split(ctx, args, 1, "eval")) if len(ctx.dgs) > 1 else 0.0
        print(f"epoch={e} loss={loss:.4f} val_ndcg={val:.4f} labels/s={n_labels / dt:.0f}")
        out["losses"].append(losses.cpu().tolist())
        out["loss"].append(loss)
        out["val_ndcg"].append(val)
        if on_epoch_end is not None:
            on_epoch_end(e)
        if e < args.epochs - 1:
            ctx.hm.reset_state()
    out["test_ndcg"] = _mean(run_split(ctx, args, len(ctx.dgs) - 1, "eval"))
    print(f"test_ndcg={out['test_ndcg']:.4f}")
    return out


def main(argv: Optional[List[str]] = None) -> Dict[str, list]:
    args = parse_args(argv)
    return run(build(args), args)


if __name__ == "__main__":
    main()
