"""GraphMixer link prediction on the port (``examples/linkproppred/graphmixer.py``).

    python -m tgm_tpu_torch.examples.linkproppred.graphmixer [--dataset synthetic]
        [--epochs 1] [--n-nbrs 20] [--time-gap 2000] [--device cuda] ...

The encoder is composed here, as in JAX: a link encoder (``Linear`` over
each recency neighbour's [edge features ‖ Time2Vec(Δt)] with the Time2Vec
frozen, two ``MLPMixer`` blocks over the (S, K, edge_dim) sequences, the
mean over valid neighbours) and a node encoder (the time-gap neighbour
mean plus the seed's own static features), joined by an output ``Linear``.

Per epoch (``_linkpred_common.run_epochs`` with ``replay``): the train
split runs through the hook pipeline (random
negatives, the shared feature-layout recency hook over [src | dst | neg],
and the split's own ``TimeGapNeighborMeanHook``) and ``train_core`` (one
encoder call over every seed, two decoder calls, masked BCE, Adam); then
val through ``eval_core`` (the embeddings of every hook seed, each TGB
candidate's row through the seed lookup, positives and candidates scored
in one decoder call); then the hook state is reset. After the epochs,
train and val are replayed through the hooks alone and test is evaluated.

Static node features are ``normal(N, 32)`` from ``--seed`` where the data
has none. The flags and defaults are the JAX example's, plus ``--device``
(default ``cuda``). ``build`` and ``run`` split ``main`` so that a caller
can load weights or replace the hooks' draws in between.
"""

from __future__ import annotations

import argparse
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from ...constants import PADDED_NODE_ID
from ...hooks import RecencyNeighborHook, TimeGapNeighborMeanHook
from ...nn import LinkPredictor, MLPMixer, Time2Vec
from ...train.programs import score_seed_rows, train_loss_and_grad
from .._linkpred_common import base_parser, run_epochs, setup_linkpred


class GraphMixerEncoder(nn.Module):
    """The JAX example's ``GraphMixerEncoder``: ``forward(batch, node_feat,
    generator=None)`` gives one (S, embed_dim) row per hook seed, [src |
    dst | neg]. Dropout only when a ``generator`` is passed.

    Modules and their JAX names: ``time_encoder`` (``Time2Vec_0``, frozen:
    its output is detached), ``link_proj`` (``Dense_0``), ``mixers[i]``
    (``MLPMixer_i``), ``output_layer`` (``Dense_1``).
    """

    requires = {
        "edge_src", "edge_dst", "nbr_edge_x", "seed_times", "nbr_edge_time",
        "nbr_nids", "time_gap_feat", "neg",
    }

    def __init__(self, time_dim: int, embed_dim: int, num_tokens: int, node_dim: int,
                 edge_dim: int, num_layers: int = 2, token_dim_expansion: float = 0.5,
                 channel_dim_expansion: float = 4.0, dropout: float = 0.1) -> None:
        super().__init__()
        self.time_encoder = Time2Vec(time_dim)
        self.link_proj = nn.Linear(edge_dim + time_dim, edge_dim)
        self.mixers = nn.ModuleList([
            MLPMixer(num_tokens, edge_dim, token_dim_expansion, channel_dim_expansion, dropout)
            for _ in range(num_layers)
        ])
        self.output_layer = nn.Linear(edge_dim + node_dim, embed_dim)

    def forward(self, batch, node_feat: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        # Link encoder: a mixer over each seed's one-hop neighbour sequence.
        edge_feat = batch.nbr_edge_x[0]  # (S, K, De)
        # The int32 gap is cast once: casting both times first rounds
        # differently once times pass 2^24.
        dt = (batch.seed_times[0][:, None] - batch.nbr_edge_time[0]).float()
        t_enc = self.time_encoder(dt).detach()  # frozen, as JAX's stop_gradient
        z_link = self.link_proj(torch.cat([edge_feat, t_enc], dim=-1))
        for mixer in self.mixers:
            z_link = mixer(z_link, generator)
        valid = batch.nbr_nids[0] != PADDED_NODE_ID
        z_link = (z_link * valid[..., None]).sum(1) / valid.sum(1, keepdim=True).clamp_min(1)

        # Node encoder: the time-gap neighbour mean plus the seed's features.
        # Ids past the table read its last row, as a JAX gather clamps them
        # (a TGB candidate may name a node no edge of the data touches).
        seeds = torch.cat([batch.edge_src, batch.edge_dst, batch.neg])
        z_node = batch.time_gap_feat + node_feat[seeds.clamp(0, node_feat.shape[0] - 1).long()]
        return self.output_layer(torch.cat([z_link, z_node], dim=1))


def build_graphmixer_cores(encoder: GraphMixerEncoder, decoder: nn.Module,
                           opt: Optional[torch.optim.Optimizer], node_x: torch.Tensor,
                           num_nodes: int) -> Tuple[Callable, Callable]:
    """The example's ``(train_core, eval_core)``.

    * ``train_core((generator,), batch) -> ((generator,), loss)``: one
      encoder call over [src | dst | neg], the (src, dst) and (src, neg)
      decoder calls, masked BCE, backward, the optimizer step. The
      ``torch.Generator`` draws the dropout masks (``None``: no dropout).
      ``train_core.loss_and_grad(batch, generator) -> loss`` is its first
      stage; ``opt.step()`` is the second.
    * ``eval_core(carry, batch) -> (carry, (mrr_sum, mrr_count))``: the
      embeddings of every hook seed, no dropout, scored as
      ``programs.score_seed_rows`` scores them (``eval_core.embed`` and
      ``eval_core.score`` are the two stages).
    """

    def loss_and_grad(batch, generator):
        if opt is None:
            raise ValueError("train_core needs an optimizer: build the cores with opt")
        return train_loss_and_grad(opt, lambda: encoder(batch, node_x, generator), decoder,
                                   batch.edge_valid)

    def train_core(carry, batch):
        (generator,) = carry
        loss = loss_and_grad(batch, generator)
        opt.step()
        return (generator,), loss

    def embed(batch):
        return encoder(batch, node_x)

    def score(batch, z):
        return score_seed_rows(decoder, batch, z, num_nodes)

    @torch.no_grad()
    def eval_core(carry, batch):
        return carry, score(batch, embed(batch))

    train_core.loss_and_grad = loss_and_grad
    eval_core.embed = torch.no_grad()(embed)
    eval_core.score = torch.no_grad()(score)
    return train_core, eval_core


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = base_parser("GraphMixer LinkPropPred Example")
    p.add_argument("--n-nbrs", type=int, default=20)
    p.add_argument("--time-gap", type=int, default=2000,
                   help="GraphMixer time slot size (window of events before "
                   "the batch feeding the node encoder's neighbor mean)")
    p.add_argument("--time-dim", type=int, default=100)
    p.add_argument("--embed-dim", type=int, default=100)
    return p.parse_args(argv)


def build(args: argparse.Namespace, data=None, cands=None) -> SimpleNamespace:
    """The example's setup (``setup_linkpred``), hooks, modules, optimizer,
    cores and dropout generator on ``args.device``; ``data`` and ``cands``
    (val and test candidates) replace the dataset ``args.dataset`` names."""
    setup = setup_linkpred(args, static_dim=32, data=data, cands=cands)
    num_nodes, edge_dim, dev = setup.num_nodes, setup.edge_dim, setup.device
    seed_keys = ["edge_src", "edge_dst", "neg"]
    # The feature-buffer layout: the rings carry the edge features (K4).
    recency = RecencyNeighborHook(num_nodes, [args.n_nbrs], seed_keys,
                                  ["edge_time", "edge_time", "neg_time"], edge_dim=edge_dim,
                                  device=dev)
    setup.hm.register_shared(recency)
    # One time-gap hook per key: the window index space is split-local.
    for key, dg in setup.dgs.items():
        s_src, s_dst, s_t = dg._storage.get_edges(dg._slice)
        setup.hm.register(key, TimeGapNeighborMeanHook(
            s_src, s_dst, s_t, setup.data.static_node_x, args.time_gap, seed_keys,
            edge_id_base=int(dg._storage._data.edge_global_offset), device=dev))

    encoder = GraphMixerEncoder(time_dim=args.time_dim, embed_dim=args.embed_dim,
                                num_tokens=args.n_nbrs, node_dim=setup.node_x.shape[1],
                                edge_dim=edge_dim, dropout=args.dropout).to(dev)
    decoder = LinkPredictor(node_dim=args.embed_dim, hidden_dim=args.embed_dim).to(dev)
    opt = torch.optim.Adam([*encoder.parameters(), *decoder.parameters()], lr=args.lr)
    setup.hm.validate_requirement(encoder)
    train_core, eval_core = build_graphmixer_cores(encoder, decoder, opt, setup.node_x,
                                                   num_nodes)
    return SimpleNamespace(setup=setup, hm=setup.hm, dgs=setup.dgs, streams=setup.streams,
                           recency=recency, encoder=encoder, decoder=decoder, opt=opt,
                           train_core=train_core, eval_core=eval_core,
                           generator=torch.Generator(device=dev).manual_seed(args.seed))


def batch_fn(ctx: SimpleNamespace, core: str) -> Callable:
    """The per-batch step of ``core`` ("train": the loss, on ``ctx``'s
    generator, which it advances; "eval": (mrr_sum, mrr_count))."""
    if core == "train":
        def train_batch(batch):
            (ctx.generator,), loss = ctx.train_core((ctx.generator,), batch)
            return loss

        return train_batch
    return lambda batch: ctx.eval_core(None, batch)[1]


def run(ctx: SimpleNamespace, args: argparse.Namespace,
        on_epoch_end: Optional[Callable[[int], None]] = None) -> Dict[str, list]:
    """The example's epochs (the hooks reset after each), the replay of
    train and val through the hooks, and test (``run_epochs`` with
    ``replay``); returns each epoch's per-batch losses, mean loss and val
    MRR, and the test MRR. ``on_epoch_end(e)`` runs after epoch ``e``'s
    val, before the reset."""
    return run_epochs(ctx.setup, args, batch_fn(ctx, "train"), batch_fn(ctx, "eval"),
                      on_epoch_end=on_epoch_end, replay=True)


def main(argv: Optional[List[str]] = None) -> Dict[str, list]:
    args = parse_args(argv)
    return run(build(args), args)


if __name__ == "__main__":
    main()
