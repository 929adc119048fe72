"""DyGFormer node property prediction on the port (``examples/nodeproppred/dygformer.py``).

    python -m tgm_tpu_torch.examples.nodeproppred.dygformer [--dataset synthetic]
        [--epochs 1] [--n-nbrs 7] [--device cuda] ...

The stream carries node-label events (``--num-classes`` classes); static
node features are ``normal(N, 8)`` from ``--seed`` where the data has none.
One hook set serves every split: the recency hook seeded by the label
nodes at their label times (feature layout, one hop of ``--n-nbrs``: kernel
K4 and the push on the card) and the seen-node track hook. Each label node
is paired with itself through DyGFormer (one layer, trainable, dropout
from a seeded ``torch.Generator``) and a ``NodePredictor``; the loss and
NDCG@10 count the label nodes already seen in edge events. Per epoch the
train split runs through the ``DGDataLoader`` and ``train_core`` (Adam on
every batch), then val through ``eval_core``, then the hook state is reset.
After the epochs, train and val are streamed through the hooks again and
test is evaluated. Each reported value is the mean over the loader's
batches.

The flags and defaults are the JAX example's, plus ``--device`` (default
``cuda``). ``--compute-bf16`` goes through ``resolve_bf16``: ``on`` builds
``DyGFormer(compute_bf16=True)``, ``auto`` resolves to off on a GPU or CPU.
"""

from __future__ import annotations

import argparse
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from ...core.graph import DGraph
from ...data.loader import DGDataLoader
from ...device import resolve_device
from ...hooks import EdgeEventsSeenNodesTrackHook, HookManager, RecencyNeighborHook
from ...nn import DyGFormer, NodePredictor
from ...train import build_dygformer_node_cores
from ...util.precision import resolve_bf16
from .._datasets import load_dataset


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="DyGFormer nodeproppred")
    p.add_argument("--dataset", type=str, default="synthetic")
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--bsize", type=int, default=200)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--n-nbrs", type=int, default=7)
    p.add_argument("--time-dim", type=int, default=32)
    p.add_argument("--channel-dim", type=int, default=16)
    p.add_argument("--embed-dim", type=int, default=64)
    p.add_argument("--compute-bf16", choices=["auto", "on", "off"], default="auto",
                   help="bf16 matmul path for the transformer/projections "
                   "(auto: on for TPU backends)")
    p.add_argument("--max-seq-len", type=int, default=8)
    p.add_argument("--num-classes", type=int, default=10)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def build(args: argparse.Namespace, data=None) -> SimpleNamespace:
    """The example's data, hooks, modules, optimizer, cores and dropout
    generator on ``args.device``; ``data`` replaces the dataset
    ``args.dataset`` names."""
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
    hm.register_shared(RecencyNeighborHook(num_nodes, [args.n_nbrs], ["node_y_nids"],
                                           ["node_y_time"], edge_dim=edge_dim, device=dev))
    hm.register_shared(EdgeEventsSeenNodesTrackHook(num_nodes, device=dev))
    encoder = DyGFormer(node_feat_dim=node_x.shape[1], edge_x_dim=edge_dim,
                        time_feat_dim=args.time_dim, channel_embedding_dim=args.channel_dim,
                        output_dim=args.embed_dim, max_input_sequence_length=args.max_seq_len,
                        dropout=args.dropout, num_layers=1,
                        compute_bf16=resolve_bf16(args.compute_bf16)).to(dev)
    decoder = NodePredictor(args.embed_dim, data.node_y.shape[1]).to(dev)
    opt = torch.optim.Adam([p for m in (encoder, decoder) for p in m.parameters()], lr=args.lr)
    train_core, eval_core = build_dygformer_node_cores(encoder, decoder, opt, node_x)
    return SimpleNamespace(device=dev, data=data, dgs=dgs, hm=hm, node_x=node_x,
                           encoder=encoder, decoder=decoder, opt=opt, train_core=train_core,
                           eval_core=eval_core,
                           generator=torch.Generator(device=dev).manual_seed(args.seed))


def run_split(ctx: SimpleNamespace, args: argparse.Namespace, split: int,
              core: Optional[str]) -> torch.Tensor:
    """Split ``split`` through the hooks and ``core`` ("train", "eval" or
    None: the hooks alone); returns each batch's loss or NDCG."""
    vals = []
    with ctx.hm.activate("all"):
        for batch in DGDataLoader(ctx.dgs[split], args.bsize, hook_manager=ctx.hm,
                                  device=ctx.device):
            if not batch.has("node_y_nids") or core is None:
                continue
            if core == "train":
                (ctx.generator,), v = ctx.train_core((ctx.generator,), batch)
            else:
                _, v = ctx.eval_core(None, batch)
            vals.append(v)
    return torch.stack(vals) if vals else torch.zeros(0)


def _mean(vals: torch.Tensor) -> float:
    return float(vals.mean()) if vals.numel() else 0.0


def run(ctx: SimpleNamespace, args: argparse.Namespace) -> Dict[str, List[float]]:
    """The example's epochs, the replay and test; returns each epoch's
    per-batch losses and mean loss, the val and test NDCG."""
    out = {"losses": [], "loss": [], "val_ndcg": []}
    n_labels = ctx.dgs[0].num_node_labels
    for e in range(args.epochs):
        t0 = time.perf_counter()
        losses = run_split(ctx, args, 0, "train")
        loss = _mean(losses)  # waits for the card
        dt = time.perf_counter() - t0
        val = _mean(run_split(ctx, args, 1, "eval")) if len(ctx.dgs) > 1 else 0.0
        print(f"epoch={e} loss={loss:.4f} val_ndcg={val:.4f} labels/s={n_labels / dt:.0f}")
        out["losses"].append(losses.cpu().tolist())
        out["loss"].append(loss)
        out["val_ndcg"].append(val)
        ctx.hm.reset_state()
    for split in range(len(ctx.dgs) - 1):
        run_split(ctx, args, split, None)
    out["test_ndcg"] = _mean(run_split(ctx, args, len(ctx.dgs) - 1, "eval"))
    print(f"test_ndcg={out['test_ndcg']:.4f}")
    return out


def main(argv: Optional[List[str]] = None) -> Dict[str, List[float]]:
    args = parse_args(argv)
    return run(build(args), args)


if __name__ == "__main__":
    main()
