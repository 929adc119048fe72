"""Serving-style TGN link scoring on the port (``examples/serving/tgn_scoring.py``).

    python -m tgm_tpu_torch.examples.serving.tgn_scoring [--dataset synthetic]
        [--epochs 1] [--ckpt DIR] [--device cuda]

Train briefly through ``TGNPipeline`` (feature recency layout, dims 32 / 32 /
16, K = 5, Adam at 1e-3), ``flush_all``, checkpoint the full carry
(weights, Adam state, memory, recency buffers, the negatives' generator),
restore it into a fresh carry, then serve the val split batch by batch:
each batch's link probabilities ``sigmoid(forward_only(...)[0])`` are
scored against the current state BEFORE ``eval_step`` (one PAD candidate
per edge) folds the batch in, so every probability is causally valid.
Prints the events/s and the mean p(link). The flags are the JAX example's,
plus ``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse
import tempfile
import time
from typing import Any, Dict, List, Optional

import torch

from ...constants import PADDED_NODE_ID
from ...core.graph import DGraph
from ...device import resolve_device
from ...train import (
    DeviceEdgeStream,
    TGNPipeline,
    jit_scan_epoch,
    restore_checkpoint,
    save_checkpoint,
)
from .._datasets import load_dataset


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="TGN serving-style link scoring")
    p.add_argument("--dataset", type=str, default="synthetic")
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--bsize", type=int, default=200)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--ckpt", type=str, default=None, help="checkpoint dir (default: a temp dir)")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Run the example; return the served events, events/s, mean p(link) and
    the per-event probabilities."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    data, _, _ = load_dataset(args.dataset)
    train_data, val_data, _ = data.split()
    train_dg, val_dg = DGraph(train_data), DGraph(val_data)
    pipe = TGNPipeline(
        num_nodes=data.num_nodes, edge_dim=train_dg.edge_x_dim or 0, memory_dim=32,
        embed_dim=32, time_dim=16, num_nbrs=5, lr=1e-3,
        neg_low=int(train_dg.edge_dst.min()), neg_high=int(train_dg.edge_dst.max()), device=dev,
    )

    # --- train + checkpoint ------------------------------------------- #
    train_stream = DeviceEdgeStream(train_dg, args.bsize, device=dev)
    epoch = jit_scan_epoch(pipe.train_step, train_stream.batch_at, train_stream.num_batches)
    carry = pipe.init_carry(args.seed)
    for _ in range(args.epochs):
        carry, _ = epoch(carry)
    carry = pipe.flush_all(carry)
    ckpt_dir = args.ckpt or tempfile.mkdtemp(prefix="tgn_serving_")
    save_checkpoint(ckpt_dir, carry)
    print(f"checkpointed full carry -> {ckpt_dir}")

    # --- restore + serve ----------------------------------------------- #
    restored = restore_checkpoint(ckpt_dir, like=pipe.init_carry(args.seed))
    serve_stream = DeviceEdgeStream(val_dg, args.bsize, device=dev)
    no_cands = torch.full((args.bsize, 1), PADDED_NODE_ID, dtype=torch.int32, device=dev)

    def serve_step(c, batch):
        # Score the incoming events against the CURRENT state, then advance
        # it (eval-mode ordering).
        scores = torch.sigmoid(pipe.forward_only(c, batch)[0])
        c, _ = pipe.eval_step(c, batch, no_cands)
        return c, scores

    serve = jit_scan_epoch(serve_step, serve_stream.batch_at, serve_stream.num_batches,
                           donate_carry=False)
    t0 = time.perf_counter()
    _, scores = serve(restored)
    n_events = serve_stream.num_edges
    probs = scores.reshape(-1)[:n_events].cpu()  # waits for the card
    dt = time.perf_counter() - t0
    mean_p = float(probs.mean())
    print(f"served {n_events} events in {dt * 1e3:.1f} ms ({n_events / dt:.0f} events/s); "
          f"mean p(link)={mean_p:.4f}")
    return {"events": n_events, "events_per_s": n_events / dt, "mean_p": mean_p, "probs": probs}


if __name__ == "__main__":
    main()
