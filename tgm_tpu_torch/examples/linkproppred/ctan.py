"""CTAN link prediction on the port (``examples/linkproppred/ctan.py``).

    python -m tgm_tpu_torch.examples.linkproppred.ctan [--dataset synthetic]
        [--epochs 1] [--n-nbrs 10] [--num-iters 1] [--device cuda] ...

The CTAN memory (a store of embeddings) feeds ``CTAN``'s antisymmetric
propagation over the batch subgraph: the shared feature-layout recency hook
over [src | dst | neg] (K4), then the shared ``DeduplicationHook`` over
``neg`` and ``nbr_nids``; messages flow seed -> neighbour. ``LinkPredictor``
scores the pairs.

Per epoch (``_linkpred_common.run_epochs``): the memory is reset, the train
split runs through ``train_core`` (masked BCE of the (src, dst) and (src,
neg) pairs, backward, the memory write of the batch's src and dst
embeddings, Adam), then val through ``eval_core`` (the TGB MRR, then the
memory write); the hooks reset between epochs; then test. The Δt
normalisation is the mean and standard deviation (floored at 1e-6) of the
train stream's successive time gaps, in float64.

Static node features are ``normal(N, 8)`` from ``--seed`` where the data
has none. The flags and defaults are the JAX example's, plus ``--device``
(default ``cuda``). ``build`` and ``run`` split ``main`` so that a caller
can load weights or replace the hooks' draws in between.
"""

from __future__ import annotations

import argparse
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ...hooks import DeduplicationHook, RecencyNeighborHook
from ...hooks.dedup import local_rows
from ...nn import CTAN, LinkPredictor, ctan_memory_init, ctan_memory_update
from ...train.programs import build_local_edges, score_dedup_rows, train_loss_and_grad
from .._linkpred_common import base_parser, run_epochs, setup_linkpred


def build_ctan_cores(encoder: CTAN, decoder: nn.Module, opt: Optional[torch.optim.Optimizer],
                     node_x: torch.Tensor, num_nodes: int) -> Tuple[Callable, Callable]:
    """The example's ``(train_core, eval_core)``; the memory state
    (``CTANMemoryState``) is the carry, written in place.

    * ``train_core(mem_state, batch) -> (mem_state, loss)``: ``CTAN`` over the
      batch's unique nodes, the (src, dst) and (src, neg) decoder calls,
      masked BCE, backward; then the memory write of the src and dst rows
      (computed with the parameters before the step); then the optimizer
      step. ``train_core.loss_and_grad(mem_state, batch) -> (loss, (z_src,
      z_dst))`` is its first stage.
    * ``eval_core(mem_state, batch) -> (mem_state, (mrr_sum, mrr_count))``:
      the TGB MRR (``score_dedup_rows``), then the memory write.
    """

    def embed(mem_state, batch):
        uids = batch.unique_nids
        rows = torch.where(uids >= 0, uids, num_nodes).long()
        feats = node_x[uids.clamp_min(0).long()] * (uids >= 0)[:, None]
        x = torch.cat([mem_state.memory[rows], feats], dim=1)
        return encoder(x, mem_state.last_update[rows], *build_local_edges(batch, num_nodes))

    def write(mem_state, batch, z_src, z_dst):
        return ctan_memory_update(mem_state, batch.edge_src, batch.edge_dst, batch.edge_time,
                                  z_src, z_dst, batch.edge_valid)

    def loss_and_grad(mem_state, batch):
        if opt is None:
            raise ValueError("train_core needs an optimizer: build the cores with opt")
        seeds = torch.cat([batch.edge_src, batch.edge_dst, batch.neg])
        kept = {}

        def seed_rows():
            z = embed(mem_state, batch)
            kept["z"] = z[local_rows(batch.global_to_local, seeds, z.shape[0])]
            return kept["z"]

        loss = train_loss_and_grad(opt, seed_rows, decoder, batch.edge_valid)
        B = batch.edge_src.shape[0]
        z = kept["z"].detach()
        return loss, (z[:B], z[B : 2 * B])

    def train_core(mem_state, batch):
        loss, (z_src, z_dst) = loss_and_grad(mem_state, batch)
        mem_state = write(mem_state, batch, z_src, z_dst)
        opt.step()
        return mem_state, loss

    @torch.no_grad()
    def eval_core(mem_state, batch):
        sums, (z_src, z_dst) = score_dedup_rows(decoder, batch, embed(mem_state, batch))
        return write(mem_state, batch, z_src, z_dst), sums

    train_core.loss_and_grad = loss_and_grad
    return train_core, eval_core


def delta_t_stats(edge_time: np.ndarray) -> Tuple[float, float]:
    """Mean and standard deviation (floored at 1e-6) of the successive time
    gaps of a stream, in float64, as the JAX example computes them."""
    t = np.asarray(edge_time, dtype=np.float64)
    dts = np.diff(t) if len(t) > 1 else np.ones(1)
    return float(dts.mean()), float(max(dts.std(), 1e-6))


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = base_parser("CTAN LinkPropPred Example")
    p.add_argument("--n-nbrs", type=int, nargs="+", default=[10])
    p.add_argument("--time-dim", type=int, default=100)
    p.add_argument("--embed-dim", type=int, default=100)
    p.add_argument("--num-iters", type=int, default=1)
    return p.parse_args(argv)


def build(args: argparse.Namespace, data=None, cands=None) -> SimpleNamespace:
    """The example's setup (``setup_linkpred``), hooks, modules, optimizer,
    cores and memory on ``args.device``; ``data`` and ``cands`` (val and test
    candidates) replace the dataset ``args.dataset`` names."""
    setup = setup_linkpred(args, static_dim=8, data=data, cands=cands)
    num_nodes, edge_dim, dev = setup.num_nodes, setup.edge_dim, setup.device
    recency = RecencyNeighborHook(num_nodes, args.n_nbrs, ["edge_src", "edge_dst", "neg"],
                                  ["edge_time", "edge_time", "neg_time"], edge_dim=edge_dim,
                                  device=dev)
    setup.hm.register_shared(recency)
    setup.hm.register_shared(DeduplicationHook(num_nodes, seed_nodes_keys=["neg", "nbr_nids"]))

    train_t = setup.train_dg._storage.get_edges(setup.train_dg._slice)[2]
    mean_dt, std_dt = delta_t_stats(train_t)
    encoder = CTAN(edge_dim=edge_dim, memory_dim=args.embed_dim, time_dim=args.time_dim,
                   node_dim=setup.node_x.shape[1], num_iters=args.num_iters,
                   mean_delta_t=mean_dt, std_delta_t=std_dt).to(dev)
    decoder = LinkPredictor(node_dim=args.embed_dim, hidden_dim=args.embed_dim).to(dev)
    opt = torch.optim.Adam([*encoder.parameters(), *decoder.parameters()], lr=args.lr)
    setup.hm.validate_requirement(encoder)
    train_core, eval_core = build_ctan_cores(encoder, decoder, opt, setup.node_x, num_nodes)
    return SimpleNamespace(setup=setup, hm=setup.hm, dgs=setup.dgs, streams=setup.streams,
                           recency=recency, encoder=encoder, decoder=decoder, opt=opt,
                           train_core=train_core, eval_core=eval_core,
                           mem=ctan_memory_init(num_nodes, args.embed_dim, device=dev))


def batch_fn(ctx: SimpleNamespace, core: str) -> Callable:
    """The per-batch step of ``core`` ("train": the loss; "eval": (mrr_sum,
    mrr_count)), reading and writing ``ctx.mem``."""
    step = ctx.train_core if core == "train" else ctx.eval_core

    def run_batch(batch):
        ctx.mem, out = step(ctx.mem, batch)
        return out

    return run_batch


def hooks(ctx: SimpleNamespace) -> Dict[str, Callable[[], None]]:
    """``run_epochs``' hooks: a fresh memory store at each epoch's start."""

    def on_epoch_start():
        ctx.mem = ctan_memory_init(ctx.setup.num_nodes, ctx.encoder.memory_dim,
                                   device=ctx.setup.device)

    return {"on_epoch_start": on_epoch_start}


def run(ctx: SimpleNamespace, args: argparse.Namespace,
        on_epoch_end: Optional[Callable[[int], None]] = None) -> Dict[str, list]:
    """The example's epochs (the memory reset at each start), then test
    (``run_epochs``); returns each epoch's per-batch losses, mean loss and
    val MRR, and the test MRR. ``on_epoch_end(e)`` runs after epoch ``e``'s
    val."""
    return run_epochs(ctx.setup, args, batch_fn(ctx, "train"), batch_fn(ctx, "eval"),
                      on_epoch_end=on_epoch_end, **hooks(ctx))


def main(argv: Optional[List[str]] = None) -> Dict[str, list]:
    args = parse_args(argv)
    return run(build(args), args)


if __name__ == "__main__":
    main()
