"""Shared scaffolding of the snapshot (discrete-time) link-prediction
examples (port of ``examples/_snapshot_common.py``).

The stream is discretized into snapshots of ``--snapshot-ticks`` time
units. A snapshot advances the encoder's recurrent state and gives the
node embeddings ``z``; event batches of ``--bsize`` edges are predicted
against the latest ``z``. The interleave of snapshots and event batches
is precomputed on the host (``train.snapshot.merged_snapshot_schedule``)
and each split runs as one loop over the (kind, index) steps from
device-resident streams; no step waits for the card, apart from the
random-negative hook's copy of its host draws (as on every train path of
the port). The streams carry no edge features: the snapshot path reads
the edges alone.

Training: BCE over the batch's edges and as many random negatives, Adam.
Eval: each edge's positive against its ``Q`` TGB candidates, scored in one
decoder call (ROADMAP fault 3), and MRR; the recurrent state continues from
training, the first eval snapshot is consumed but not applied, and test
runs only when val improves.

The snapshot step returns detached embeddings (the JAX examples'
``stop_gradient``), so the loss reaches no encoder parameter: the JAX
examples train the decoder alone, and Adam leaves the encoder's
parameters (ROLAND's ``tau`` too) at their initial values (ROADMAP fault
22). The port keeps that behaviour: it runs the snapshot step under
``torch.no_grad`` and gives the optimizer the decoder's parameters, which
moves every parameter exactly as optax's Adam over both, whose updates of
zero gradients are zero.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, replace
from types import SimpleNamespace
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..constants import PADDED_NODE_ID
from ..core.graph import DGraph
from ..data.dg_data import DGData
from ..data.loader import DGDataLoader
from ..device import resolve_device
from ..eval.metrics import mrr_sum_count
from ..hooks import RandomNegativeEdgeSamplerHook
from ..nn import LinkPredictor
from ..timedelta import TimeDeltaDG
from ..train.programs import score_candidates, tie_equal_candidates, train_loss_and_grad
from ..train.snapshot import merged_snapshot_schedule, plan_edge_max_times, scanned_snapshot_epoch
from ..train.stream import DeviceEdgeStream, DeviceEventStream
from ._datasets import load_dataset

STATIC_DIM = 16  # static node features drawn where the data has none


def snapshot_parser(description: str) -> argparse.ArgumentParser:
    """The JAX snapshot examples' common flags and defaults, plus
    ``--device`` (default ``cuda``)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--dataset", type=str, default="synthetic")
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--bsize", type=int, default=200)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--embed-dim", type=int, default=64)
    p.add_argument("--snapshot-ticks", type=int, default=100, help="graph ticks a snapshot")
    p.add_argument("--device", type=str, default="cuda")
    return p


@dataclass
class SnapshotSetup:
    data: DGData
    train_data: DGData
    val_data: DGData
    test_data: DGData
    val_cands: np.ndarray
    test_cands: np.ndarray
    node_x: torch.Tensor
    num_nodes: int
    device: torch.device


def setup_snapshot(args, data: Optional[DGData] = None, cands=None) -> SnapshotSetup:
    """The dataset ``args.dataset`` names (or ``data`` with ``cands``, its val
    and test candidates), static node features ``normal(N, 16)`` from
    ``args.seed`` where it has none, and its splits."""
    dev = resolve_device(args.device)
    torch.manual_seed(args.seed)
    if data is None:
        data, val_cands, test_cands = load_dataset(args.dataset)
    else:
        val_cands, test_cands = cands
    if data.static_node_x is None:
        rng = np.random.default_rng(args.seed)
        data.static_node_x = rng.normal(size=(data.num_nodes, STATIC_DIM)).astype(np.float32)
    train_data, val_data, test_data = data.split()
    return SnapshotSetup(data=data, train_data=train_data, val_data=val_data,
                         test_data=test_data, val_cands=val_cands, test_cands=test_cands,
                         node_x=torch.as_tensor(data.static_node_x, device=dev),
                         num_nodes=data.num_nodes, device=dev)


def random_negatives(train_data: DGData, device, seed: int) -> RandomNegativeEdgeSamplerHook:
    """The train split's random-negative hook: ids in [min dst, max dst), as
    JAX draws them (its ``high`` is exclusive)."""
    dst = train_data.edge_index[:, 1]
    return RandomNegativeEdgeSamplerHook(low=int(dst.min()), high=int(dst.max()),
                                         device=device, seed=seed)


def build_context(args, setup: SnapshotSetup, encoder: torch.nn.Module,
                  snap_apply: Callable[[Any, Any], Any],
                  init_rec: Callable[[], Any]) -> SimpleNamespace:
    """An example's ``ctx``: ``setup``, ``encoder``, the ``LinkPredictor``
    ``decoder`` (embed -> embed -> 1), Adam over the decoder (fault 22), the
    snapshot step ``snap_apply(rec, sbatch) -> (z, rec)``, ``init_rec()``
    and the train split's ``random_negatives`` hook ``neg_hook``."""
    dev = setup.device
    decoder = LinkPredictor(node_dim=args.embed_dim, hidden_dim=args.embed_dim).to(dev)
    return SimpleNamespace(setup=setup, encoder=encoder, decoder=decoder,
                           opt=torch.optim.Adam(decoder.parameters(), lr=args.lr),
                           snap_apply=snap_apply, init_rec=init_rec,
                           neg_hook=random_negatives(setup.train_data, dev, args.seed))


def run(ctx: SimpleNamespace, args) -> Dict[str, Any]:
    """``run_snapshot_linkpred`` over ``ctx``'s splits and modules."""
    s = ctx.setup
    return run_snapshot_linkpred(
        args, s.train_data, s.num_nodes, ctx.snap_apply, ctx.init_rec, ctx.decoder, ctx.opt,
        val_data=s.val_data, test_data=s.test_data, val_cands=s.val_cands,
        test_cands=s.test_cands, neg_hook=ctx.neg_hook, device=s.device)


def build_snapshot_linkpred(
    args,
    train_data: DGData,
    num_nodes: int,
    snap_apply: Callable[[Any, Any], Any],
    init_rec: Callable[[], Any],
    decoder: torch.nn.Module,
    opt: torch.optim.Optimizer,
    val_data: Optional[DGData] = None,
    test_data: Optional[DGData] = None,
    val_cands: Optional[np.ndarray] = None,
    test_cands: Optional[np.ndarray] = None,
    neg_hook: Optional[RandomNegativeEdgeSamplerHook] = None,
    device=None,
) -> SimpleNamespace:
    """The cores and each split's scheduled epoch of ``run_snapshot_linkpred``.

    The carry is ``(rec, z)``. ``snapshot_core(carry, sbatch)`` runs
    ``snap_apply`` without autograd; ``train_core(carry, batch, idx) ->
    (carry, (loss, 1))`` draws the negatives, steps the optimizer; an eval
    core gives ``(mrr_sum, count)``. ``epochs[split]`` holds ``epoch(carry)
    -> (carry, a, b)``, its edge ``core``, its schedule ``kinds``/``idxs``,
    its discretized ``snap_data`` and its ``snap_stream``/``edge_stream``;
    ``fresh_carry()`` is a new ``(rec, z)``.
    """
    dev = resolve_device(device)
    ticks = args.snapshot_ticks
    coarse = TimeDeltaDG("s", ticks)
    if neg_hook is None:
        neg_hook = random_negatives(train_data, dev, args.seed)
    neg_hook.init_state()
    safe = lambda ids: ids.long().clamp(0, num_nodes - 1)
    one = torch.ones((), device=dev)

    def snapshot_core(carry, sbatch):
        rec, _ = carry
        with torch.no_grad():
            z, rec = snap_apply(rec, sbatch)
        return rec, z

    def train_core(carry, batch, idx):
        _, z = carry
        _, batch = neg_hook.apply(None, batch)
        ids = torch.cat([batch.edge_src, batch.edge_dst, batch.neg])
        loss = train_loss_and_grad(opt, lambda: z[safe(ids)], decoder, batch.edge_valid)
        opt.step()
        return carry, (loss, one)

    def make_eval_core(cands: np.ndarray, nb: int):
        B, Q = args.bsize, cands.shape[1]
        padded = np.full((nb * B, Q), PADDED_NODE_ID, np.int32)
        padded[: len(cands)] = cands
        cands_d = torch.as_tensor(padded, device=dev)

        @torch.no_grad()
        def eval_core(carry, batch, idx):
            _, z = carry
            rows = cands_d[idx * B : (idx + 1) * B]
            z_dst, z_cand = z[safe(batch.edge_dst)], z[safe(rows)]
            pos, negs = score_candidates(decoder, z[safe(batch.edge_src)], z_dst, z_cand)
            negs = tie_equal_candidates(pos, negs, z_dst, z_cand)
            return carry, mrr_sum_count(pos, negs, neg_valid=rows != PADDED_NODE_ID,
                                        edge_valid=batch.edge_valid)

        return eval_core

    def build_epoch(split_data: DGData, edge_core, apply_first: bool) -> SimpleNamespace:
        split_data = replace(split_data, edge_x=None)
        sd = split_data.discretize(coarse)
        dg = DGraph(split_data)
        snap_stream = DeviceEventStream(DGDataLoader(DGraph(sd), ticks, batch_unit="s", device=dev))
        edge_stream = DeviceEdgeStream(dg, args.bsize, device=dev)
        snap_max = plan_edge_max_times(snap_stream._plan, sd.edge_time)
        _, _, t_host = dg._storage.get_edges(dg._slice)
        E, B = len(t_host), args.bsize
        ends = np.minimum((np.arange(edge_stream.num_batches) + 1) * B, E) - 1
        kinds, idxs = merged_snapshot_schedule(snap_max, np.asarray(t_host)[ends], ticks,
                                               apply_first=apply_first)
        epoch = scanned_snapshot_epoch(kinds, idxs, snap_stream.batch_at, edge_stream.batch_at,
                                       snapshot_core, edge_core)
        return SimpleNamespace(epoch=epoch, core=edge_core, kinds=kinds, idxs=idxs, snap_data=sd,
                               snap_stream=snap_stream, edge_stream=edge_stream)

    def fresh_carry():
        return init_rec(), torch.zeros((num_nodes, args.embed_dim), device=dev)

    epochs = {"train": build_epoch(train_data, train_core, apply_first=True)}
    for split, split_data, cands in (("val", val_data, val_cands),
                                     ("test", test_data, test_cands)):
        if split_data is not None and cands is not None:
            nb = max(1, -(-split_data.num_edge_events // args.bsize))
            epochs[split] = build_epoch(split_data, make_eval_core(cands, nb), apply_first=False)
    return SimpleNamespace(epochs=epochs, snapshot_core=snapshot_core, train_core=train_core,
                           fresh_carry=fresh_carry)


def run_snapshot_linkpred(
    args,
    train_data: DGData,
    num_nodes: int,
    snap_apply: Callable[[Any, Any], Any],
    init_rec: Callable[[], Any],
    decoder: torch.nn.Module,
    opt: torch.optim.Optimizer,
    val_data: Optional[DGData] = None,
    test_data: Optional[DGData] = None,
    val_cands: Optional[np.ndarray] = None,
    test_cands: Optional[np.ndarray] = None,
    neg_hook: Optional[RandomNegativeEdgeSamplerHook] = None,
    device=None,
) -> Dict[str, Any]:
    """Train (and, given val and test data with their (E_split, Q)
    candidates, evaluate) a snapshot link-prediction model on ``device``.

    ``snap_apply(rec, sbatch) -> (z, rec)`` advances the model over one
    snapshot; ``init_rec()`` is the state at each epoch's start. Each epoch
    trains from a fresh state, then val continues from it, and test runs
    from val's state when val MRR improves. Returns each epoch's per-batch
    losses (on the host), mean loss and val MRR, the test MRR, and the
    final ``carry`` ``(rec, z)``.
    """
    prog = build_snapshot_linkpred(args, train_data, num_nodes, snap_apply, init_rec, decoder,
                                   opt, val_data, test_data, val_cands, test_cands, neg_hook,
                                   device)

    def ratio(a, b) -> float:
        return float(a.sum() / b.sum().clamp_min(1.0))

    out: Dict[str, Any] = {"losses": [], "loss": [], "val_mrr": [], "test_mrr": 0.0}
    train, val, test = (prog.epochs.get(k) for k in ("train", "val", "test"))
    best_val = 0.0
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        carry, losses, counts = train.epoch(prog.fresh_carry())
        loss = ratio(losses, counts)  # waits for the card
        dt = time.perf_counter() - t0
        out["losses"].append(losses.cpu().numpy()[train.kinds == 1].tolist())
        out["loss"].append(loss)
        line = f"epoch={epoch} loss={loss:.4f} train_edges/s={train_data.num_edge_events / dt:.0f}"
        if val is not None:
            carry, s, c = val.epoch(carry)
            val_mrr = ratio(s, c)
            out["val_mrr"].append(val_mrr)
            line += f" val_mrr={val_mrr:.4f}"
            if test is not None and val_mrr > best_val:
                best_val = val_mrr
                carry, s, c = test.epoch(carry)
                out["test_mrr"] = ratio(s, c)
        print(line)
    if test is not None:
        print(f"test_mrr={out['test_mrr']:.4f}")
    out["carry"] = carry
    return out


__all__ = ["SnapshotSetup", "build_context", "build_snapshot_linkpred", "random_negatives", "run",
           "run_snapshot_linkpred", "setup_snapshot", "snapshot_parser"]
