"""Shared scaffolding of the link-prediction examples (port of
``examples/_linkpred_common.py``).

``setup_linkpred`` builds the dataset and its splits, static node features
where the data has none, the train/val/test hook manager (random
negatives for train, TGB candidates for val and test) and one
``DeviceEdgeStream`` per split; ``run_epochs`` runs the epochs (train,
then val, the hooks reset between epochs), then test, around step
functions the example provides; the examples register their own neighbour
hooks on ``setup.hm``. Each split runs through its key's hook
pipeline batch by batch (``hook_epoch``), on ``args.device``. The
parameter-free baselines run val and test alone (``run_baseline``).
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..core.graph import DGraph
from ..data.dg_data import DGData
from ..device import resolve_device
from ..eval.metrics import mrr_per_edge
from ..hooks import HookManager, RandomNegativeEdgeSamplerHook, TGBNegativeEdgeSamplerHook
from ..train import DeviceEdgeStream, hook_epoch
from ..util.seed import seed_everything
from ._datasets import load_dataset

SPLITS = ("train", "val", "test")


def base_parser(description: str) -> argparse.ArgumentParser:
    """The JAX flags (seed, dataset, bsize, epochs, lr, dropout), plus
    ``--device`` (default ``cuda``)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--dataset", type=str, default="synthetic")
    p.add_argument("--bsize", type=int, default=200)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--device", type=str, default="cuda")
    return p


@dataclass
class LinkPredSetup:
    data: DGData
    train_dg: DGraph
    val_dg: DGraph
    test_dg: DGraph
    hm: HookManager
    node_x: torch.Tensor
    num_nodes: int
    edge_dim: int
    device: torch.device
    neg_hooks: Dict[str, Any] = field(default_factory=dict)
    streams: Dict[str, DeviceEdgeStream] = field(default_factory=dict)

    @property
    def dgs(self) -> Dict[str, DGraph]:
        return {"train": self.train_dg, "val": self.val_dg, "test": self.test_dg}


def setup_linkpred(args, static_dim: int = 1, data: Optional[DGData] = None,
                   cands=None, load: Callable = load_dataset,
                   neg_hook: type = TGBNegativeEdgeSamplerHook) -> LinkPredSetup:
    """The dataset ``load(args.dataset)`` gives (or ``data`` with ``cands``,
    its val and test candidates), static node features ``normal(N,
    static_dim)`` from ``args.seed`` where it has none, the hook manager and
    the streams. Val and test take their candidates from ``neg_hook`` (a
    TGB candidate hook class), given the arrays, or, where ``load`` gives
    none, loaded from the TGB package for ``args.dataset``."""
    dev = resolve_device(args.device)
    seed_everything(args.seed)
    if data is None:
        data, val_cands, test_cands = load(args.dataset)
    else:
        val_cands, test_cands = cands
    if data.static_node_x is None:
        rng = np.random.default_rng(args.seed)
        data.static_node_x = rng.normal(size=(data.num_nodes, static_dim)).astype(np.float32)
    train_dg, val_dg, test_dg = (DGraph(d) for d in data.split())

    hm = HookManager(keys=list(SPLITS))
    dst = train_dg.edge_dst
    neg_hooks = {
        "train": RandomNegativeEdgeSamplerHook(low=int(dst.min()), high=int(dst.max()),
                                               device=dev, seed=args.seed),
    }
    for split, c in (("val", val_cands), ("test", test_cands)):
        neg_hooks[split] = (
            neg_hook(c, device=dev, seed=args.seed) if c is not None
            else neg_hook(dataset_name=args.dataset, split_mode=split, device=dev, seed=args.seed))
    for key, h in neg_hooks.items():
        hm.register(key, h)
    setup = LinkPredSetup(data=data, train_dg=train_dg, val_dg=val_dg, test_dg=test_dg, hm=hm,
                          node_x=torch.as_tensor(data.static_node_x, device=dev),
                          num_nodes=data.num_nodes, edge_dim=train_dg.edge_x_dim or 0,
                          device=dev, neg_hooks=neg_hooks)
    setup.streams = {k: DeviceEdgeStream(dg, args.bsize, device=dev)
                     for k, dg in setup.dgs.items()}
    return setup


def run_split(setup: LinkPredSetup, split: str, batch_fn: Callable[[Any], Any]):
    """``split`` through its key's hooks and ``batch_fn(batch)``, batch by
    batch; returns the stacked outputs and keeps the final hook states."""
    epoch, states = hook_epoch(setup.streams[split], setup.hm, split, setup.dgs[split],
                               lambda carry, batch: (carry, batch_fn(batch)))
    _, states, outs = epoch(None, states)
    setup.hm.adopt_states(split, states)
    return outs


def baseline_batch(score: Callable, update: Callable) -> Callable:
    """The per-batch step of a parameter-free baseline: ``score(src, dst)``
    over each positive and its TGB candidates in one call, each edge's
    reciprocal rank (``mrr_per_edge``, padded candidates masked), then
    ``update(src, dst, t)`` with the whole batch (the predictors skip its
    padding rows). Returns ``(rr, edge_valid)``; nothing waits for the card."""

    def step(batch):
        src, dst, cands = batch.edge_src, batch.edge_dst, batch.neg_batch_list
        B, Q = cands.shape
        s = score(torch.cat([src, src.repeat_interleave(Q)]), torch.cat([dst, cands.reshape(-1)]))
        rr = mrr_per_edge(s[:B], s[B:].reshape(B, Q), neg_valid=batch.neg_valid)
        update(src, dst, batch.edge_time)
        return rr, batch.edge_valid

    return step


def run_baseline(setup: LinkPredSetup, score: Callable, update: Callable) -> Dict[str, Any]:
    """Val then test through ``baseline_batch``: each split's reciprocal
    ranks of its valid edges (``{split}_rr``, on the device) and MRR, and
    the events a second over both."""
    out: Dict[str, Any] = {}
    t0 = time.perf_counter()
    for split in ("val", "test"):
        rr, valid = run_split(setup, split, baseline_batch(score, update))
        out[f"{split}_rr"] = rr[valid]  # waits for the card
        out[f"{split}_mrr"] = float(out[f"{split}_rr"].double().mean())
    dt = time.perf_counter() - t0
    n = setup.streams["val"].num_edges + setup.streams["test"].num_edges
    out["events_per_s"] = n / dt
    print(f"val_mrr={out['val_mrr']:.4f} test_mrr={out['test_mrr']:.4f} events/s={n / dt:.0f}")
    return out


def run_epochs(
    setup: LinkPredSetup,
    args,
    train_batch: Callable[[Any], torch.Tensor],
    eval_batch: Callable[[Any], tuple],
    on_epoch_start: Optional[Callable[[], None]] = None,
    on_train_end: Optional[Callable[[], None]] = None,
    on_test_start: Optional[Callable[[], None]] = None,
    on_epoch_end: Optional[Callable[[int], None]] = None,
    replay: bool = False,
) -> Dict[str, Any]:
    """The standard epoch loop: train then val each epoch, the hooks reset
    between epochs (not after the last), then test. With ``replay`` (the
    GraphMixer example's flow) the hooks reset after every epoch and train
    and val run through them alone before test.

    ``train_batch(batch) -> loss`` and ``eval_batch(batch) -> (rr_sum,
    count)`` own every state update. ``on_epoch_end(epoch)`` (the port's
    addition) runs after each epoch's val, before the reset. Returns each
    epoch's per-batch losses, mean loss and val MRR, and the test MRR.
    """

    def mrr(outs) -> float:
        s, c = outs
        return float(s.sum() / c.sum().clamp_min(1.0))

    out: Dict[str, Any] = {"losses": [], "loss": [], "val_mrr": []}
    n_edges = setup.streams["train"].num_edges
    for epoch in range(args.epochs):
        if on_epoch_start:
            on_epoch_start()
        t0 = time.perf_counter()
        losses = run_split(setup, "train", train_batch)
        loss = float(losses.mean())  # waits for the card
        dt = time.perf_counter() - t0
        if on_train_end:
            on_train_end()
        val_mrr = mrr(run_split(setup, "val", eval_batch))
        print(f"epoch={epoch} loss={loss:.4f} val_mrr={val_mrr:.4f} "
              f"train_edges/s={n_edges / dt:.0f}")
        out["losses"].append(losses.cpu().tolist())
        out["loss"].append(loss)
        out["val_mrr"].append(val_mrr)
        if on_epoch_end:
            on_epoch_end(epoch)
        if replay or epoch < args.epochs - 1:
            setup.hm.reset_state()
    if replay:
        for split in ("train", "val"):
            run_split(setup, split, lambda batch: torch.zeros(()))

    if on_test_start:
        on_test_start()
    out["test_mrr"] = mrr(run_split(setup, "test", eval_batch))
    print(f"test_mrr={out['test_mrr']:.4f}")
    return out


__all__ = ["LinkPredSetup", "base_parser", "baseline_batch", "run_baseline", "run_epochs",
           "run_split", "setup_linkpred"]
