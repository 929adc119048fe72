"""TPNet link prediction on the port (``examples/linkproppred/tpnet.py``).

    python -m tgm_tpu_torch.examples.linkproppred.tpnet [--dataset synthetic]
        [--epochs 1] [--n-nbrs 20] [--rp-layers 2] [--device cuda] ...

TPNet over the shared feature-layout recency hook (one hop of K, seeds
[src | dst | neg]) with random-projection pairwise features (``--rp-layers``
layers of ``min(64, N)`` columns, decay ``--rp-time-decay``). Per epoch
(``_linkpred_common.run_epochs``): the RP state starts anew from its
initial draw; the train split runs through ``train_core`` (the (src, dst)
and (src, neg) calls with one dropout draw, BCE, backward, ``rp_update``,
Adam); the RP state is backed up; val runs through ``eval_core`` (every
(src, candidate) pair, TGB MRR, ``rp_update``); the hooks reset between
epochs. Before test the backup is reloaded, so val's RP updates are
dropped while the recency hook keeps val (ROADMAP fault 18, as in JAX).

Static node features are ``normal(N, 8)`` from ``--seed`` where the data
has none; layer 0 of the RP state is drawn from a generator seeded with
``--seed`` on the device. The flags and defaults are the JAX example's,
plus ``--device`` (default ``cuda``), less ``--rp-dim-factor``, which the
JAX example parses and never reads. ``build`` and ``run`` split ``main``
so that a caller can load weights, replace the RP state's initial draw or
the hooks' draws in between.
"""

from __future__ import annotations

import argparse
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import torch

from ...hooks import RecencyNeighborHook
from ...nn import LinkPredictor, RandomProjectionModule, TPNet
from ...train import build_tpnet_link_cores
from .._linkpred_common import base_parser, run_epochs, setup_linkpred


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = base_parser("TPNet LinkPropPred Example")
    p.add_argument("--n-nbrs", type=int, default=20)
    p.add_argument("--time-dim", type=int, default=100)
    p.add_argument("--embed-dim", type=int, default=100)
    p.add_argument("--rp-layers", type=int, default=2)
    p.add_argument("--rp-time-decay", type=float, default=1e-6)
    return p.parse_args(argv)


def build(args: argparse.Namespace, data=None, cands=None) -> SimpleNamespace:
    """The example's setup, hooks, modules, optimizer, cores, dropout
    generator and initial RP state (``rp_state0``) on ``args.device``."""
    setup = setup_linkpred(args, static_dim=8, data=data, cands=cands)
    num_nodes, edge_dim, dev = setup.num_nodes, setup.edge_dim, setup.device
    recency = RecencyNeighborHook(num_nodes, [args.n_nbrs], ["edge_src", "edge_dst", "neg"],
                                  ["edge_time", "edge_time", "neg_time"], edge_dim=edge_dim,
                                  device=dev)
    setup.hm.register_shared(recency)
    rp = RandomProjectionModule(
        num_nodes=num_nodes, num_layer=args.rp_layers, time_decay_weight=args.rp_time_decay,
        beginning_time=float(setup.train_dg.start_time or 0), use_matrix=False,
        enforce_dim=min(64, num_nodes))
    encoder = TPNet(node_feat_dim=setup.node_x.shape[1], edge_x_dim=edge_dim,
                    time_feat_dim=args.time_dim, output_dim=args.embed_dim,
                    num_neighbors=args.n_nbrs, dropout=args.dropout,
                    random_projections=rp).to(dev)
    decoder = LinkPredictor(node_dim=args.embed_dim, hidden_dim=args.embed_dim).to(dev)
    opt = torch.optim.Adam([*encoder.parameters(), *decoder.parameters()], lr=args.lr)
    train_core, eval_core = build_tpnet_link_cores(encoder, decoder, opt, setup.node_x,
                                                   num_nodes)
    rp_state0 = rp.init_state(torch.Generator(device=dev).manual_seed(args.seed))
    return SimpleNamespace(setup=setup, hm=setup.hm, dgs=setup.dgs, streams=setup.streams,
                           recency=recency, rp=rp, encoder=encoder, decoder=decoder, opt=opt,
                           train_core=train_core, eval_core=eval_core, rp_state0=rp_state0,
                           rp_state=rp_state0, backup=None,
                           generator=torch.Generator(device=dev).manual_seed(args.seed))


def batch_fn(ctx: SimpleNamespace, core: str) -> Callable:
    """The per-batch step of ``core`` ("train": the loss; "eval": (mrr_sum,
    mrr_count)) on ``ctx``'s generator and RP state, which it advances."""
    if core == "train":
        def train_batch(batch):
            (ctx.generator, ctx.rp_state), loss = ctx.train_core((ctx.generator, ctx.rp_state),
                                                                 batch)
            return loss

        return train_batch

    def eval_batch(batch):
        ctx.rp_state, out = ctx.eval_core(ctx.rp_state, batch)
        return out

    return eval_batch


def epoch_hooks(ctx: SimpleNamespace) -> Dict[str, Callable[[], None]]:
    """``run_epochs``' ``on_epoch_start`` (the RP state from its initial
    draw), ``on_train_end`` (the backup) and ``on_test_start`` (the backup
    reloaded) on ``ctx``'s RP state."""

    def on_epoch_start():
        ctx.rp_state = ctx.rp.reload_random_projections(ctx.rp_state0)

    def on_train_end():
        # Snapshot the RP state before val, so test resumes from it.
        ctx.backup = ctx.rp.backup_random_projections(ctx.rp_state)

    def on_test_start():
        if ctx.backup is not None:
            ctx.rp_state = ctx.rp.reload_random_projections(ctx.backup)

    return dict(on_epoch_start=on_epoch_start, on_train_end=on_train_end,
                on_test_start=on_test_start)


def run(ctx: SimpleNamespace, args: argparse.Namespace,
        on_epoch_end: Optional[Callable[[int], None]] = None) -> Dict[str, list]:
    """The example's epochs and test (``run_epochs``); returns each epoch's
    per-batch losses, mean loss and val MRR, and the test MRR.
    ``on_epoch_end(e)`` runs after epoch ``e``'s val, before the reset."""
    return run_epochs(ctx.setup, args, batch_fn(ctx, "train"), batch_fn(ctx, "eval"),
                      on_epoch_end=on_epoch_end, **epoch_hooks(ctx))


def main(argv: Optional[List[str]] = None) -> Dict[str, list]:
    args = parse_args(argv)
    return run(build(args), args)


if __name__ == "__main__":
    main()
