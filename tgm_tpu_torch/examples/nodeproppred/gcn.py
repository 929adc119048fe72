"""GCN snapshot node property prediction on the port (``examples/nodeproppred/gcn.py``).

    python -m tgm_tpu_torch.examples.nodeproppred.gcn [--dataset synthetic]
        [--epochs 1] [--snapshot-ticks 100] [--device cuda] ...

The stream carries node-label events (``--num-classes`` classes); static
node features are ``normal(N, 16)`` from ``--seed`` where the data has
none. Each split runs two loaders, as the JAX example does: a snapshot
loader over the split discretized into ``--snapshot-ticks`` windows
(``materialize_features=False``) advances the encoder, and an event loader
of ``--bsize`` events gives the label batches. The split starts from
``init_H`` and the first snapshot; after each event batch the snapshots
advance while the batch's latest edge time lies past the current
snapshot's end. A batch with labels trains the ``NodePredictor`` on the
latest embeddings (soft-label cross-entropy over its valid labels, Adam)
or is scored by NDCG@10; each reported value is the mean over those
batches. Val and test start anew from ``init_H``.

Both loaders' plans are known before a split starts, so the interleave is
computed on the host (``merged_snapshot_schedule`` over the batches the
loaders would yield) and each split runs from ``DeviceEventStream``s; no
step waits for the card. Two behaviours of the JAX example are kept:

* the snapshot step's output is detached, so only the head trains and the
  encoder keeps its initial weights (ROADMAP fault 22); the step runs
  under ``torch.no_grad`` and Adam holds the head's parameters;
* a snapshot window whose only events are labels is a batch whose edges
  are all padding: it is applied (``z`` from self-loops alone) and sets the
  snapshot clock to 0, so the next event batch pulls snapshots until one
  has edges (ROADMAP fault 23).

``make_encoder``, ``snapshot_apply`` and ``init_H`` are the hooks the TGCN
and GC-LSTM examples pass in. The flags and defaults are the JAX
example's, plus ``--device`` (default ``cuda``). ``build`` and ``run``
split ``main`` so that a caller can load weights in between.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import replace
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ...core.graph import DGraph
from ...data.loader import DGDataLoader
from ...device import resolve_device
from ...eval.metrics import ndcg_at_k
from ...nn import GCN, NodePredictor
from ...timedelta import TimeDeltaDG
from ...train.programs import _label_loss_and_grad
from ...train.snapshot import merged_snapshot_schedule, plan_edge_max_times, scanned_snapshot_epoch
from ...train.stream import DeviceEventStream
from .._datasets import load_dataset

STATIC_DIM = 16  # static node features drawn where the data has none


def node_parser(description: str) -> argparse.ArgumentParser:
    """The JAX snapshot node examples' flags and defaults, plus ``--device``."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--dataset", type=str, default="synthetic")
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--bsize", type=int, default=200)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--embed-dim", type=int, default=64)
    p.add_argument("--snapshot-ticks", type=int, default=100)
    p.add_argument("--num-classes", type=int, default=10)
    p.add_argument("--device", type=str, default="cuda")
    return p


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    return node_parser("GCN snapshot nodeproppred").parse_args(argv)


def make_encoder(args, node_dim: int) -> torch.nn.Module:
    return GCN(node_dim, args.embed_dim, args.embed_dim, num_layers=2)


def snapshot_apply(encoder, node_x, H, sbatch):
    """``(z, H)`` after snapshot ``sbatch``: the GCN keeps no state."""
    z = encoder(node_x, sbatch.edge_src, sbatch.edge_dst, None, sbatch.edge_valid)
    return z, None


def init_H(num_nodes: int, dim: int, device) -> Any:
    return None


def split_program(split_data, ticks: int, bsize: int, device, snapshot_core, label_core):
    """One split's schedule (``kinds``, ``idxs``), its batches (``snap_at(i)``,
    ``ev_at(i)``: the ``i``-th each loader yields, from device streams) and
    ``epoch(carry) -> (carry, vals, ones)``; the schedule's event steps are
    the batches with labels. ``snap_rows``, ``snap_plan`` and ``snap_data``
    locate the snapshots in the discretized split."""
    split_data = replace(split_data, edge_x=None)  # the path reads no edge feature
    sd = split_data.discretize(TimeDeltaDG("s", ticks))
    snap_loader = DGDataLoader(DGraph(sd), ticks, batch_unit="s", materialize_features=False,
                               device=device)
    ev_loader = DGDataLoader(DGraph(split_data), bsize, device=device)
    snap_rows, ev_rows = snap_loader.nonempty(), ev_loader.nonempty()
    snap_max = plan_edge_max_times(snap_loader.plan(), sd.edge_time)[snap_rows]
    ev_max = plan_edge_max_times(ev_loader.plan(), split_data.edge_time)[ev_rows]
    kinds, idxs = merged_snapshot_schedule(snap_max, ev_max, ticks, apply_first=True)
    counts = ev_loader.plan().node_y_counts
    labelled = np.zeros(len(ev_rows), bool) if counts is None else counts[ev_rows] > 0
    keep = kinds == 0
    keep[~keep] = labelled[idxs[~keep]]
    if len(snap_rows) == 0:  # the JAX example's run returns 0 without a step
        keep[:] = False
    kinds, idxs = kinds[keep], idxs[keep]
    snap_stream, ev_stream = DeviceEventStream(snap_loader), DeviceEventStream(ev_loader)
    snap_at = lambda i: snap_stream.batch_at(int(snap_rows[i]))
    ev_at = lambda i: ev_stream.batch_at(int(ev_rows[i]))
    epoch = scanned_snapshot_epoch(kinds, idxs, snap_at, ev_at, snapshot_core, label_core)
    return SimpleNamespace(epoch=epoch, kinds=kinds, idxs=idxs, snap_at=snap_at, ev_at=ev_at,
                           snap_rows=snap_rows, snap_plan=snap_loader.plan(), snap_data=sd)


def build(args: argparse.Namespace, data=None, make_encoder: Callable = make_encoder,
          snapshot_apply: Callable = snapshot_apply, init_H: Callable = init_H
          ) -> SimpleNamespace:
    """The example's data, modules, optimizer, cores and each split's
    program on ``args.device``; ``data`` replaces the dataset
    ``args.dataset`` names."""
    dev = resolve_device(args.device)
    torch.manual_seed(args.seed)
    if data is None:
        data, _, _ = load_dataset(args.dataset, node_label_classes=args.num_classes)
    if data.static_node_x is None:
        rng = np.random.default_rng(args.seed)
        data.static_node_x = rng.normal(size=(data.num_nodes, STATIC_DIM)).astype(np.float32)
    num_nodes = data.num_nodes
    node_x = torch.as_tensor(data.static_node_x, device=dev)
    encoder = make_encoder(args, node_x.shape[1]).to(dev)
    head = NodePredictor(args.embed_dim, data.node_y.shape[1]).to(dev)
    opt = torch.optim.Adam(head.parameters(), lr=args.lr)  # fault 22: the head alone
    safe = lambda ids: ids.long().clamp(0, num_nodes - 1)
    one = torch.ones((), device=dev)

    def snapshot_core(carry, sbatch):
        H, _ = carry
        with torch.no_grad():
            z, H = snapshot_apply(encoder, node_x, H, sbatch)
        return H, z

    def train_core(carry, batch, idx):
        _, z = carry
        loss = _label_loss_and_grad(opt, lambda: head(z[safe(batch.node_y_nids)]), batch)
        opt.step()
        return carry, (loss, one)

    @torch.no_grad()
    def eval_core(carry, batch, idx):
        _, z = carry
        logits = head(z[safe(batch.node_y_nids)])
        return carry, (ndcg_at_k(logits, batch.node_y, k=10, row_valid=batch.node_y_valid), one)

    splits = data.split()
    progs = {name: split_program(s, args.snapshot_ticks, args.bsize, dev, snapshot_core,
                                 train_core if name == "train" else eval_core)
             for name, s in zip(("train", "val", "test"), splits)}
    return SimpleNamespace(device=dev, data=data, num_nodes=num_nodes, node_x=node_x,
                           encoder=encoder, head=head, opt=opt, progs=progs,
                           snapshot_core=snapshot_core, train_core=train_core,
                           eval_core=eval_core,
                           fresh_carry=lambda: (init_H(num_nodes, args.embed_dim, dev), None))


def run_split(ctx: SimpleNamespace, split: str) -> np.ndarray:
    """One split from a fresh state; each labelled batch's loss or NDCG."""
    prog = ctx.progs[split]
    _, vals, _ = prog.epoch(ctx.fresh_carry())
    return vals.cpu().numpy()[prog.kinds == 1].astype(np.float64)


def _mean(vals: np.ndarray) -> float:
    return float(np.mean(vals)) if len(vals) else 0.0


def run(ctx: SimpleNamespace, args: argparse.Namespace) -> Dict[str, Any]:
    """The example's epochs, then test; returns each epoch's per-batch
    losses and mean loss, the val NDCG and the test NDCG."""
    out: Dict[str, Any] = {"losses": [], "loss": [], "val_ndcg": []}
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        losses = run_split(ctx, "train")  # waits for the card
        dt = time.perf_counter() - t0
        val = _mean(run_split(ctx, "val")) if "val" in ctx.progs else 0.0
        out["losses"].append(losses.tolist())
        out["loss"].append(_mean(losses))
        out["val_ndcg"].append(val)
        print(f"epoch={epoch} loss={out['loss'][-1]:.4f} val_ndcg={val:.4f} ({dt:.1f}s)")
    out["test_ndcg"] = _mean(run_split(ctx, list(ctx.progs)[-1]))
    print(f"test_ndcg={out['test_ndcg']:.4f}")
    return out


def main(argv: Optional[List[str]] = None, parse: Callable = parse_args, **hooks):
    args = parse(argv)
    return run(build(args, **hooks), args)


if __name__ == "__main__":
    main()
