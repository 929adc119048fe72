"""TGN link prediction on the port (``examples/linkproppred/tgn.py``).

    python -m tgm_tpu_torch.examples.linkproppred.tgn [--dataset synthetic] [--epochs 1]
        [--fast] [--device cuda] ...

Per epoch: the memory is re-initialised, the train split runs through the
hook pipeline (random negatives, then the shared eid-layout recency hook)
and ``train_core`` (staged memory, attention with dropout,
``LinkPredictor``, BCE, backward, the train-mode memory commit, Adam);
then ``flush_all``, val, and test whenever val MRR reaches its best; the
hook state is reset between epochs.

``--encoder rowwise`` (the default) attends per seed over its own
neighbours; ``--encoder segment`` is the reference example's formulation:
a shared ``DeduplicationHook`` after the recency hook, memory staged over
the batch's unique nodes and the segment ``GraphAttentionEmbedding`` over
the batch subgraph.

``--fast`` trains the train split through the fused rowwise
``TGNPipeline`` instead, whatever ``--encoder`` says, as the JAX
``run_fast`` does (``jit_scan_epoch`` over ``train_step``; no dropout, as
in the JAX pipeline), and prints each epoch's mean loss and train edges/s.
The flags and defaults are the JAX example's, plus ``--device`` (default
``cuda``).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import torch

from ...core.graph import DGraph
from ...device import resolve_device
from ...hooks import (
    DeduplicationHook,
    HookManager,
    RandomNegativeEdgeSamplerHook,
    RecencyNeighborHook,
    TGBNegativeEdgeSamplerHook,
)
from ...nn import (
    GraphAttentionEmbedding,
    GraphAttentionEmbeddingRowwise,
    LinkPredictor,
    TGNMemory,
)
from ...train import (
    DeviceEdgeStream,
    TGNPipeline,
    build_tgn_hook_cores,
    hook_epoch,
    jit_scan_epoch,
)
from .._datasets import load_dataset


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="TGN LinkPropPred Example")
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--dataset", type=str, default="synthetic")
    p.add_argument("--bsize", type=int, default=200)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--n-nbrs", type=int, nargs="+", default=[10])
    p.add_argument("--time-dim", type=int, default=100)
    p.add_argument("--embed-dim", type=int, default=100)
    p.add_argument("--memory-dim", type=int, default=100)
    p.add_argument("--log-file-path", type=str, default=None,
                   help="append each metric as a JSON line to this file")
    p.add_argument("--fast", action="store_true",
                   help="train through the fused TGNPipeline (jit_scan_epoch over train_step) "
                   "instead of the hook-manager path")
    p.add_argument("--encoder", type=str, default="rowwise", choices=["rowwise", "segment"],
                   help="rowwise: dense per-seed attention (no dedup); segment: the reference "
                   "example's dedup + segment-softmax subgraph wiring")
    p.add_argument("--eager", action="store_true",
                   help="accepted for the JAX example's command lines: the port's epochs "
                   "are per-batch Python loops either way")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def log_metric(path: Optional[str], metric: str, value: float, **extra) -> None:
    """Append ``{"metric": ..., "value": ...}`` as a JSON line to ``path``, if given."""
    if path:
        with open(path, "a") as f:
            f.write(json.dumps({"metric": metric, "value": value, **extra}) + "\n")


def run_fast(args: argparse.Namespace) -> Dict[str, float]:
    """Epochs of the train split through ``TGNPipeline`` (the JAX ``run_fast``);
    returns the last epoch's mean loss and train edges/s."""
    dev = resolve_device(args.device)
    data, _, _ = load_dataset(args.dataset)
    train_data, _, _ = data.split()
    dg = DGraph(train_data)
    stream = DeviceEdgeStream(dg, args.bsize, device=dev)
    pipe = TGNPipeline(
        num_nodes=data.num_nodes, edge_dim=dg.edge_x_dim or 0, memory_dim=args.memory_dim,
        embed_dim=args.embed_dim, time_dim=args.time_dim, num_nbrs=args.n_nbrs[0], lr=args.lr,
        neg_low=int(dg.edge_dst.min()), neg_high=int(dg.edge_dst.max()),
        edge_x_full=stream.edge_x, device=dev,
    )
    carry = pipe.init_carry(args.seed)
    epoch = jit_scan_epoch(pipe.train_step, stream.batch_at, stream.num_batches)
    loss, edges_per_s = float("nan"), 0.0
    for e in range(args.epochs):
        t0 = time.perf_counter()
        carry, losses = epoch(carry)
        loss = float(losses.mean())  # waits for the card
        edges_per_s = stream.num_edges / (time.perf_counter() - t0)
        log_metric(args.log_file_path, "loss", loss, epoch=e)
        print(f"epoch={e} loss={loss:.4f} train_edges/s={edges_per_s:.0f}")
    return {"loss": loss, "train_edges_per_s": edges_per_s}


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    """Run the example; return the last epoch's loss and val MRR, and the
    test MRR (with ``--fast``: ``run_fast``'s loss and train edges/s)."""
    args = parse_args(argv)
    if args.fast:
        return run_fast(args)
    dev = resolve_device(args.device)
    torch.manual_seed(args.seed)

    data, val_cands, test_cands = load_dataset(args.dataset)
    num_nodes = data.num_nodes
    dgs = dict(zip(("train", "val", "test"), (DGraph(d) for d in data.split())))
    edge_dim = dgs["train"].edge_x_dim or 0

    # --- hooks -------------------------------------------------------- #
    hm = HookManager(keys=["train", "val", "test"])
    dst = dgs["train"].edge_dst
    hm.register("train", RandomNegativeEdgeSamplerHook(
        low=int(dst.min()), high=int(dst.max()), device=dev, seed=args.seed))
    hm.register("val", TGBNegativeEdgeSamplerHook(val_cands, device=dev, seed=args.seed))
    hm.register("test", TGBNegativeEdgeSamplerHook(test_cands, device=dev, seed=args.seed))
    # eid-layout buffers: features come from the PRE-SPLIT table so the
    # global edge ids of every split resolve.
    hm.register_shared(RecencyNeighborHook(
        num_nodes, args.n_nbrs, ["edge_src", "edge_dst", "neg"],
        ["edge_time", "edge_time", "neg_time"], edge_dim=edge_dim, edge_x_full=data.edge_x,
        device=dev))
    if args.encoder == "segment":
        hm.register_shared(DeduplicationHook(num_nodes, seed_nodes_keys=["neg", "nbr_nids"]))

    # --- model -------------------------------------------------------- #
    memory = TGNMemory(num_nodes, edge_dim, args.memory_dim, args.time_dim).to(dev)
    enc_cls = GraphAttentionEmbeddingRowwise if args.encoder == "rowwise" else GraphAttentionEmbedding
    encoder = enc_cls(
        args.memory_dim, args.embed_dim, edge_dim, args.time_dim, dropout=args.dropout,
    ).to(dev)
    decoder = LinkPredictor(node_dim=args.embed_dim, hidden_dim=args.embed_dim).to(dev)
    opt = torch.optim.Adam(
        [p for m in (memory, encoder, decoder) for p in m.parameters()], lr=args.lr
    )
    train_core, eval_core = build_tgn_hook_cores(
        memory, encoder, decoder, opt, num_nodes, style=args.encoder
    )
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    streams = {k: DeviceEdgeStream(dg, args.bsize, device=dev) for k, dg in dgs.items()}

    def run_eval(split: str, mem_state):
        epoch, states = hook_epoch(streams[split], hm, split, dgs[split], eval_core)
        mem_state, states, (s, c) = epoch(mem_state, states)
        hm.adopt_states(split, states)
        return mem_state, float(s.sum() / c.sum().clamp_min(1.0))

    best_val, test_mrr, loss, val_mrr = 0.0, 0.0, float("nan"), 0.0
    for e in range(args.epochs):
        t0 = time.perf_counter()
        mem_state = memory.init_state(dev)
        epoch, states = hook_epoch(streams["train"], hm, "train", dgs["train"], train_core)
        (mem_state, generator), states, losses = epoch((mem_state, generator), states)
        hm.adopt_states("train", states)
        loss = float(losses.mean())  # waits for the card
        train_dt = time.perf_counter() - t0
        mem_state = memory.flush_all(mem_state)  # train -> eval transition
        mem_state, val_mrr = run_eval("val", mem_state)
        log_metric(args.log_file_path, "loss", loss, epoch=e)
        log_metric(args.log_file_path, "val_mrr", val_mrr, epoch=e)
        print(f"epoch={e} loss={loss:.4f} val_mrr={val_mrr:.4f} "
              f"train_edges/s={streams['train'].num_edges / train_dt:.0f}")
        if val_mrr >= best_val:
            best_val = val_mrr
            mem_state, test_mrr = run_eval("test", mem_state)
            log_metric(args.log_file_path, "test_mrr", test_mrr, epoch=e)
        if e < args.epochs - 1:
            hm.reset_state()
    print(f"test_mrr={test_mrr:.4f}")
    return {"loss": loss, "val_mrr": val_mrr, "test_mrr": test_mrr}


if __name__ == "__main__":
    main()
