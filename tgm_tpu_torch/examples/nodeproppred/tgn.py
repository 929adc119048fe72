"""TGN node property prediction on the port (``examples/nodeproppred/tgn.py``).

    python -m tgm_tpu_torch.examples.nodeproppred.tgn [--dataset synthetic]
        [--epochs 1] [--eager] [--device cuda] ...

The stream carries node-label events (``--num-classes`` classes). One hook
set serves every split: the recency hook seeded by the label nodes at their
label times (feature layout), then the dedup hook over the batch's edges and
the neighbours. Per epoch the memory is re-initialised, the train split runs
through ``train_core`` (memory staged over the batch's unique nodes, the
segment ``GraphAttentionEmbedding``, ``NodePredictor``, soft-label
cross-entropy, backward, the flush-then-store commit with the old weights,
Adam; batches without labels only commit), then val through ``eval_core``
(NDCG@10); the hook state is reset between epochs; test follows the last
epoch. Each reported value is the mean over the batches with labels.

By default each split runs as the JAX example's scanned epoch: a
``DeviceEventStream`` over the loader's plan through
``scanned_hook_epoch``; ``--eager`` iterates the ``DGDataLoader`` instead.
The flags and defaults are the JAX example's, plus ``--device`` (default
``cuda``).
"""

from __future__ import annotations

import argparse
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import torch

from ...core.graph import DGraph
from ...data.loader import DGDataLoader
from ...device import resolve_device
from ...hooks import DeduplicationHook, HookManager, RecencyNeighborHook
from ...nn import GraphAttentionEmbedding, NodePredictor, TGNMemory
from ...train import DeviceEventStream, build_tgn_node_cores, scanned_hook_epoch
from .._datasets import load_dataset


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="TGN nodeproppred")
    p.add_argument("--dataset", type=str, default="synthetic")
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--bsize", type=int, default=200)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--n-nbrs", type=int, nargs="+", default=[10])
    p.add_argument("--time-dim", type=int, default=32)
    p.add_argument("--embed-dim", type=int, default=64)
    p.add_argument("--memory-dim", type=int, default=64)
    p.add_argument("--num-classes", type=int, default=10)
    p.add_argument("--eager", action="store_true",
                   help="per-batch loader loop instead of the default scanned epochs")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def build(args: argparse.Namespace, data=None) -> SimpleNamespace:
    """The example's data, hooks, modules, optimizer and cores on
    ``args.device``; ``data`` replaces the dataset ``args.dataset`` names."""
    dev = resolve_device(args.device)
    torch.manual_seed(args.seed)
    if data is None:
        data, _, _ = load_dataset(args.dataset, node_label_classes=args.num_classes)
    num_nodes = data.num_nodes
    dgs = [DGraph(s) for s in data.split()]
    edge_dim = dgs[0].edge_x_dim or 0

    hm = HookManager(keys=["all"])
    hm.register_shared(RecencyNeighborHook(num_nodes, args.n_nbrs, ["node_y_nids"],
                                           ["node_y_time"], edge_dim=edge_dim, device=dev))
    hm.register_shared(DeduplicationHook(num_nodes, seed_nodes_keys=["nbr_nids"]))

    memory = TGNMemory(num_nodes, edge_dim, args.memory_dim, args.time_dim).to(dev)
    encoder = GraphAttentionEmbedding(args.memory_dim, args.embed_dim, edge_dim,
                                      args.time_dim).to(dev)
    decoder = NodePredictor(args.embed_dim, data.node_y.shape[1]).to(dev)
    opt = torch.optim.Adam([p for m in (memory, encoder, decoder) for p in m.parameters()],
                           lr=args.lr)
    train_core, eval_core = build_tgn_node_cores(memory, encoder, decoder, opt, num_nodes)
    return SimpleNamespace(device=dev, data=data, dgs=dgs, hm=hm, memory=memory,
                           encoder=encoder, decoder=decoder, opt=opt, train_core=train_core,
                           eval_core=eval_core, streams={})


def run_split(ctx: SimpleNamespace, args: argparse.Namespace, split: int, mem_state,
              train: bool):
    """One pass of split ``split`` (0 train, 1 val, 2 test); returns
    ``(mem_state, vals, has)``: each batch's loss or NDCG and whether it
    held labels (scanned: every batch of the plan; ``--eager``: the
    loader's non-empty batches)."""
    dg, core = ctx.dgs[split], ctx.train_core if train else ctx.eval_core
    if args.eager:
        vals, has = [], []
        with ctx.hm.activate("all"):
            loader = DGDataLoader(dg, args.bsize, hook_manager=ctx.hm, device=ctx.device)
            for batch in loader:
                mem_state, (v, h) = core(mem_state, batch)
                vals.append(v)
                has.append(h)
        return mem_state, torch.stack(vals), torch.stack(has)
    if split not in ctx.streams:
        ctx.streams[split] = DeviceEventStream(DGDataLoader(dg, args.bsize, device=ctx.device))
    epoch, states = scanned_hook_epoch(ctx.streams[split], ctx.hm, "all", dg, core)
    mem_state, states, (vals, has) = epoch(mem_state, states)
    ctx.hm.adopt_states("all", states)
    return mem_state, vals, has


def mean_over_labelled(vals: torch.Tensor, has: torch.Tensor) -> float:
    """The mean of ``vals`` over the batches with labels (0 if none)."""
    vals = vals.cpu()
    return float(vals[has].mean()) if bool(has.any()) else 0.0


def run(ctx: SimpleNamespace, args: argparse.Namespace) -> Dict[str, List[float]]:
    """The example's epochs, val and test; returns each epoch's per-batch
    losses and labelled flags, the val and test NDCG."""
    out = {"losses": [], "has": [], "val_ndcg": [], "loss": []}
    n_labels = ctx.dgs[0].num_node_labels
    for e in range(args.epochs):
        mem_state = ctx.memory.init_state(ctx.device)
        t0 = time.perf_counter()
        mem_state, losses, has = run_split(ctx, args, 0, mem_state, True)
        loss = mean_over_labelled(losses, has)  # waits for the card
        dt = time.perf_counter() - t0
        val = 0.0
        if len(ctx.dgs) > 1:
            mem_state, vals, vhas = run_split(ctx, args, 1, mem_state, False)
            val = mean_over_labelled(vals, vhas)
        print(f"epoch={e} loss={loss:.4f} val_ndcg={val:.4f} labels/s={n_labels / dt:.0f}")
        out["losses"].append(losses.cpu().tolist())
        out["has"].append(has.tolist())
        out["loss"].append(loss)
        out["val_ndcg"].append(val)
        if e < args.epochs - 1:
            ctx.hm.reset_state()
    mem_state, vals, vhas = run_split(ctx, args, len(ctx.dgs) - 1, mem_state, False)
    out["test_ndcg"] = mean_over_labelled(vals, vhas)
    print(f"test_ndcg={out['test_ndcg']:.4f}")
    return out


def main(argv: Optional[List[str]] = None) -> Dict[str, List[float]]:
    args = parse_args(argv)
    return run(build(args), args)


if __name__ == "__main__":
    main()
