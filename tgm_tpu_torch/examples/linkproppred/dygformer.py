"""DyGFormer link prediction on the port (``examples/linkproppred/dygformer.py``).

    python -m tgm_tpu_torch.examples.linkproppred.dygformer [--dataset synthetic]
        [--epochs 1] [--dyg-stack auto] [--dyg-pairs split] [--device cuda] ...

Per epoch: the train split runs through the hook pipeline (random
negatives, then the shared feature-buffer recency hook over [src | dst |
neg]) and ``train_core`` (the (src, dst) and (src, neg) pairs through
DyGFormer with dropout, ``LinkPredictor``, BCE, backward, Adam); then val
through ``eval_core`` with 20 TGB candidates per edge; then the hook state
is reset. After the epochs, train and val are replayed through the hooks
alone and test is evaluated.

The flags and defaults are the JAX example's, plus ``--device`` (default
``cuda``), ``--dyg-stack`` (the eval stack: ``kernel`` is K5, ``module``
the layers' modules, ``auto`` the kernel on ``cuda`` and the modules on
``cpu``, as ``bench.py`` picks) and ``--dyg-pairs`` (``split``: two encoder
calls per train step; ``fused``: one ``encode_pairs``). ``--compute-bf16``
goes through ``resolve_bf16``: ``on`` builds ``DyGFormer(compute_bf16=True)``
(evaluated through K5 or the modules as ``--dyg-stack`` says), ``auto``
resolves to off on a GPU or CPU. ``--eager`` is accepted: the port's epochs
are per-batch Python loops either way.
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
    RandomNegativeEdgeSamplerHook,
    RecencyNeighborHook,
    TGBNegativeEdgeSamplerHook,
)
from ...nn import DyGFormer, LinkPredictor
from ...util.precision import resolve_bf16
from ...train import (
    DeviceEdgeStream,
    build_dygformer_eval_core,
    build_dygformer_train_core,
    hook_epoch,
)
from .._datasets import load_dataset


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="DyGFormer LinkPropPred Example")
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--dataset", type=str, default="synthetic")
    p.add_argument("--bsize", type=int, default=200)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--n-nbrs", type=int, default=20)
    p.add_argument("--time-dim", type=int, default=100)
    p.add_argument("--channel-dim", type=int, default=50)
    p.add_argument("--embed-dim", type=int, default=172)
    p.add_argument("--patch-size", type=int, default=1)
    p.add_argument("--max-seq-len", type=int, default=32)
    p.add_argument("--compute-bf16", choices=["auto", "on", "off"], default="auto",
                   help="bf16 matmul path for the transformer/projections "
                   "(auto: on for TPU backends)")
    p.add_argument("--eager", action="store_true",
                   help="accepted for the JAX example's command lines: the port's epochs "
                   "are per-batch Python loops either way")
    p.add_argument("--dyg-stack", choices=["auto", "module", "kernel"], default="auto",
                   help="eval transformer stack: kernel K5, the layers' modules, or auto "
                   "(the kernel on cuda, the modules on cpu)")
    p.add_argument("--dyg-pairs", choices=["split", "fused"], default="split",
                   help="train pairs: two encoder calls, or one encode_pairs call")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    """Run the example; return the last epoch's loss and val MRR, and the test MRR."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    stack = args.dyg_stack
    if stack == "auto":
        stack = "kernel" if dev.type == "cuda" else "module"
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
    # The feature-buffer layout: the rings carry the edge features.
    hm.register_shared(RecencyNeighborHook(
        num_nodes, [args.n_nbrs], ["edge_src", "edge_dst", "neg"],
        ["edge_time", "edge_time", "neg_time"], edge_dim=edge_dim, device=dev))

    # --- model -------------------------------------------------------- #
    encoder = DyGFormer(
        node_feat_dim=node_x.shape[1], edge_x_dim=edge_dim, time_feat_dim=args.time_dim,
        channel_embedding_dim=args.channel_dim, output_dim=args.embed_dim,
        patch_size=args.patch_size, max_input_sequence_length=args.max_seq_len,
        dropout=args.dropout, compute_bf16=resolve_bf16(args.compute_bf16),
    ).to(dev)
    decoder = LinkPredictor(node_dim=args.embed_dim, hidden_dim=args.embed_dim).to(dev)
    opt = torch.optim.Adam([*encoder.parameters(), *decoder.parameters()], lr=args.lr)
    train_core = build_dygformer_train_core(encoder, decoder, opt, node_x, pairs=args.dyg_pairs)
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    streams = {k: DeviceEdgeStream(dg, args.bsize, device=dev) for k, dg in dgs.items()}

    def run_eval(split: str) -> float:
        # Built after the optimizer steps: the kernel stack's weights are
        # converted when the core is built.
        eval_core = build_dygformer_eval_core(encoder, decoder, node_x, num_nodes, stack=stack)
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
        print(f"epoch={e} loss={loss:.4f} val_mrr={val_mrr:.4f} "
              f"train_edges/s={streams['train'].num_edges / train_dt:.0f}")
        hm.reset_state()

    replay("train")
    replay("val")
    test_mrr = run_eval("test")
    print(f"test_mrr={test_mrr:.4f}")
    return {"loss": loss, "val_mrr": val_mrr, "test_mrr": test_mrr}


if __name__ == "__main__":
    main()
