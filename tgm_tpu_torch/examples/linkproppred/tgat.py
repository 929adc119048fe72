"""TGAT link prediction on the port (``examples/linkproppred/tgat.py``).

    python -m tgm_tpu_torch.examples.linkproppred.tgat [--dataset synthetic]
        [--epochs 1] [--n-nbrs 20 20] [--device cuda] ...

Per epoch: the train split runs through the hook pipeline (random
negatives, then the shared multi-hop neighbour hook over [src | dst | neg]:
the recency hook in the eid layout, or with ``--sampling uniform`` the
uniform ``NeighborSamplerHook`` over train's temporal CSR, as in JAX) and
``train_core`` (TGAT with dropout,
``LinkPredictor``, BCE, backward, Adam); then val through ``eval_core``
with the TGB candidates; then the hook state is reset. After the epochs,
train and val are replayed through the hooks alone and test is evaluated.

Node features are ``normal(N, 1)`` from ``--seed``, as in the JAX example.
The flags and defaults are the JAX example's, plus ``--device`` (default
``cuda``). ``--eager`` is accepted: the port's epochs are per-batch
Python loops either way. The uniform sampler's draws come from a generator
on the device seeded with ``--seed``. The attention takes
``kv_bf16=default_attn_bf16()``, as in the JAX example: off on a GPU or CPU.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ...core.graph import DGraph
from ...device import resolve_device
from ...hooks import (
    HookManager,
    NeighborSamplerHook,
    RandomNegativeEdgeSamplerHook,
    RecencyNeighborHook,
    TGBNegativeEdgeSamplerHook,
)
from ...nn import TGAT, LinkPredictor
from ...train import DeviceEdgeStream, build_tgat_eval_core, build_tgat_train_core, hook_epoch
from ...train.tgat_pipeline import default_attn_bf16
from .._datasets import load_dataset
from .tgn import log_metric


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="TGAT LinkPropPred Example")
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--dataset", type=str, default="synthetic")
    p.add_argument("--bsize", type=int, default=200)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--n-heads", type=int, default=2)
    p.add_argument("--n-nbrs", type=int, nargs="+", default=[20, 20])
    p.add_argument("--time-dim", type=int, default=100)
    p.add_argument("--embed-dim", type=int, default=172)
    p.add_argument("--sampling", type=str, default="recency", choices=["uniform", "recency"])
    p.add_argument("--log-file-path", type=str, default=None,
                   help="append each metric as a JSON line to this file")
    p.add_argument("--eager", action="store_true",
                   help="accepted for the JAX example's command lines: the port's epochs "
                   "are per-batch Python loops either way")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    """Run the example; return the last epoch's loss and val MRR, and the test MRR."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    torch.manual_seed(args.seed)

    data, val_cands, test_cands = load_dataset(args.dataset)
    num_nodes = data.num_nodes
    rng = np.random.default_rng(args.seed)
    node_x = torch.as_tensor(rng.normal(size=(num_nodes, 1)).astype(np.float32), device=dev)
    dgs = dict(zip(("train", "val", "test"), (DGraph(d) for d in data.split())))
    edge_dim = dgs["train"].edge_x_dim or 0

    # --- hooks -------------------------------------------------------- #
    hm = HookManager(keys=["train", "val", "test"])
    dst = dgs["train"].edge_dst
    hm.register("train", RandomNegativeEdgeSamplerHook(
        low=int(dst.min()), high=int(dst.max()), device=dev, seed=args.seed))
    hm.register("val", TGBNegativeEdgeSamplerHook(val_cands, device=dev, seed=args.seed))
    hm.register("test", TGBNegativeEdgeSamplerHook(test_cands, device=dev, seed=args.seed))
    seed_keys = ["edge_src", "edge_dst", "neg"]
    time_keys = ["edge_time", "edge_time", "neg_time"]
    if args.sampling == "recency":
        # eid-layout rings over the PRE-SPLIT feature table, one K1 launch a hop.
        hm.register_shared(RecencyNeighborHook(
            num_nodes, args.n_nbrs, seed_keys, time_keys, edge_dim=edge_dim,
            edge_x_full=data.edge_x, device=dev))
    else:
        hm.register_shared(NeighborSamplerHook(args.n_nbrs, seed_keys, time_keys, device=dev,
                                               seed=args.seed))

    # --- model -------------------------------------------------------- #
    encoder = TGAT(node_dim=node_x.shape[1], edge_dim=edge_dim, time_dim=args.time_dim,
                   embed_dim=args.embed_dim, num_layers=len(args.n_nbrs), n_heads=args.n_heads,
                   dropout=args.dropout, kv_bf16=default_attn_bf16()).to(dev)
    decoder = LinkPredictor(node_dim=args.embed_dim).to(dev)
    opt = torch.optim.Adam([*encoder.parameters(), *decoder.parameters()], lr=args.lr)
    train_core = build_tgat_train_core(encoder, decoder, opt, node_x)
    eval_core = build_tgat_eval_core(encoder, decoder, node_x, num_nodes)
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    streams = {k: DeviceEdgeStream(dg, args.bsize, device=dev) for k, dg in dgs.items()}

    def run_eval(split: str) -> float:
        epoch, states = hook_epoch(streams[split], hm, split, dgs[split], eval_core)
        _, states, (s, c) = epoch(None, states)
        hm.adopt_states(split, states)
        return float(s.sum() / c.sum().clamp_min(1.0))

    def replay(split: str) -> None:
        """Advance the hook state over a split without the model."""
        epoch, states = hook_epoch(streams[split], hm, split, dgs[split],
                                   lambda carry, batch: (carry, torch.zeros(())))
        _, states, _ = epoch(None, states)
        hm.adopt_states(split, states)

    loss, val_mrr = float("nan"), 0.0
    for e in range(args.epochs):
        t0 = time.perf_counter()
        epoch, states = hook_epoch(streams["train"], hm, "train", dgs["train"], train_core)
        (generator,), states, losses = epoch((generator,), states)
        hm.adopt_states("train", states)
        loss = float(losses.mean())  # waits for the card
        train_dt = time.perf_counter() - t0
        val_mrr = run_eval("val")
        log_metric(args.log_file_path, "loss", loss, epoch=e)
        log_metric(args.log_file_path, "val_mrr", val_mrr, epoch=e)
        print(f"epoch={e} loss={loss:.4f} val_mrr={val_mrr:.4f} "
              f"train_edges/s={streams['train'].num_edges / train_dt:.0f}")
        hm.reset_state()

    # Final pass: replay train and val through the hooks, then test.
    replay("train")
    replay("val")
    test_mrr = run_eval("test")
    log_metric(args.log_file_path, "test_mrr", test_mrr)
    print(f"test_mrr={test_mrr:.4f}")
    return {"loss": loss, "val_mrr": val_mrr, "test_mrr": test_mrr}


if __name__ == "__main__":
    main()
