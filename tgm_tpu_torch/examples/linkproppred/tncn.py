"""TNCN link prediction on the port (``examples/linkproppred/tncn.py``): TGN
memory and the segment ``GraphAttentionEmbedding`` scored by the Neural
Common Neighbor decoder.

    python -m tgm_tpu_torch.examples.linkproppred.tncn [--dataset synthetic]
        [--epochs 1] [--ncn-k {2,4,8}] [--cn-time-decay] [--device cuda] ...

Hooks: the shared feature-layout recency hook over [src | dst | neg] (K4),
then the shared ``DeduplicationHook`` over ``neg`` and ``nbr_nids``. The
memory is staged (train mode, in train and eval alike) over the batch's
unique nodes; the encoder's (seed -> neighbour) edges are the recency
slots. For k in {2, 4} the adjacency rows of every hook seed are built once
a batch (``ncn_adjacency_rows``, in train and eval alike: the JAX example's
eval takes its blocked form, bit-equal) and shared by the pairs; k = 8
scores over the dense adjacency.

Per epoch (``_linkpred_common.run_epochs``): the memory is reset; each
train batch computes the loss and its gradients, then commits with the
parameters before the step (``flush`` of the valid endpoints, then the
message store), then steps Adam; ``flush_all`` ends training; each val
batch scores (the TGB MRR), then stores the messages, then flushes, the
reverse of train's order (ROADMAP fault 21); the hooks reset between
epochs; then test.

The flags and defaults are the JAX example's, plus ``--device`` (default
``cuda``), less ``--exec``: the JAX example's occurrence-space train
scoring tied with this table path on the H100 and held more memory
(``scripts/torch_tncn_ab.py``), so the port trains one way. ``build``
and ``run`` split ``main`` so that a caller can load weights or replace
the hooks' draws in between.
"""

from __future__ import annotations

import argparse
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ...constants import PADDED_NODE_ID
from ...eval.metrics import mrr_sum_count
from ...hooks import DeduplicationHook, RecencyNeighborHook
from ...hooks.dedup import candidate_rows, map_to_local, seed_lookup
from ...nn import GraphAttentionEmbedding, NCNPredictor, TGNMemory
from ...nn.decoder.ncnpred import _dense_adj, ncn_adjacency_rows
from ...train.programs import (
    bce_with_logits,
    build_local_edges,
    tgn_eval_commit,
    tgn_train_commit,
    tie_equal_candidates,
    zero_every_grad,
)
from .._linkpred_common import base_parser, run_epochs, setup_linkpred


def _nbr_ok(batch) -> torch.Tensor:
    return ((batch.nbr_nids[0] != PADDED_NODE_ID)
            & (batch.seed_nids[0][:, None] != PADDED_NODE_ID))


def build_tncn_cores(memory: TGNMemory, encoder: GraphAttentionEmbedding,
                     decoder: NCNPredictor, opt: Optional[torch.optim.Optimizer],
                     num_nodes: int) -> Tuple[Callable, Callable]:
    """The example's ``(train_core, eval_core)``; the TGN memory state is
    written in place.

    * ``train_core((mem_state, generator), batch) -> ((mem_state, generator),
      loss)``: the masked BCE of the (src, dst) and (src, neg) pairs and its
      backward (the encoder's dropout drawn from ``generator``, ``None`` for
      none), then the commit with the
      parameters before the step (flush, then store), then the optimizer
      step. ``train_core.loss_and_grad(mem_state, batch, generator)`` is
      its first stage and ``train_core.commit(mem_state, batch)`` its
      second.
    * ``eval_core(mem_state, batch) -> (mem_state, (mrr_sum, mrr_count))``:
      the positives and the TGB candidates scored in one MLP call (a
      candidate whose MLP input equals the positive's bit for bit gets the
      positive's score, ROADMAP fault 3), the TGB MRR, then the eval commit
      (store, then flush).
    """
    use_rows = decoder.k in (2, 4)

    def seed_rows(batch, num_local: int):
        g2l = batch.global_to_local
        return ncn_adjacency_rows(map_to_local(g2l, batch.seed_nids[0]),
                                  map_to_local(g2l, batch.nbr_nids[0]), _nbr_ok(batch),
                                  num_local)

    def encode(mem_state, batch, generator=None):
        z_mem, last_upd = memory.stage(mem_state, batch.unique_nids, training=True)
        e_src, e_dst, e_t, e_x, e_valid = build_local_edges(batch, num_nodes)
        z = encoder(z_mem, last_upd, e_src, e_dst, e_t, e_x, e_valid, generator=generator)
        rows = seed_rows(batch, z.shape[0]) if use_rows else None
        return z, last_upd, (e_src, e_dst, e_valid, rows)

    def features(z, last_upd, sub, batch, src, dst, t, rows_i=None, rows_j=None):
        """The decoder's MLP input rows of the (src, dst) pairs."""
        g2l = batch.global_to_local
        e_src, e_dst, e_valid, _ = sub
        A = None if rows_i is not None else _dense_adj(e_src, e_dst, z.shape[0], e_valid)
        return decoder.pair_features(z, map_to_local(g2l, src), map_to_local(g2l, dst), A=A,
                                     row1_i=rows_i, row1_j=rows_j, last_update=last_upd,
                                     edge_time=t)

    def train_scores(mem_state, batch, generator):
        B = batch.edge_src.shape[0]
        z, last_upd, sub = encode(mem_state, batch, generator)
        rows = sub[3]
        # Both pair sets in one decoder pass: k = 8 builds its products once.
        pair_rows = {} if rows is None else dict(
            rows_i=torch.cat([rows[:B], rows[:B]]), rows_j=torch.cat([rows[B : 2 * B],
                                                                      rows[2 * B :]]))
        xs = features(z, last_upd, sub, batch, batch.edge_src.repeat(2),
                      torch.cat([batch.edge_dst, batch.neg]), batch.edge_time.repeat(2),
                      **pair_rows)
        scores = decoder.xsmlp(xs).reshape(-1)
        return scores[:B], scores[B:]

    def loss_and_grad(mem_state, batch, generator):
        if opt is None:
            raise ValueError("train_core needs an optimizer: build the cores with opt")
        zero_every_grad(opt)
        with torch.enable_grad():
            pos, neg = train_scores(mem_state, batch, generator)
            loss = (bce_with_logits(pos, torch.ones_like(pos), batch.edge_valid)
                    + bce_with_logits(neg, torch.zeros_like(neg), batch.edge_valid))
            loss.backward()
        return loss.detach()

    def commit(mem_state, batch):
        return tgn_train_commit(memory, mem_state, batch, num_nodes)

    def train_core(carry, batch):
        mem_state, generator = carry
        loss = loss_and_grad(mem_state, batch, generator)
        mem_state = commit(mem_state, batch)  # with the parameters before the step
        opt.step()
        return (mem_state, generator), loss

    @torch.no_grad()
    def eval_core(mem_state, batch):
        B, Q = batch.neg_batch_list.shape
        z, last_upd, sub = encode(mem_state, batch)
        rows = sub[3]
        negs = batch.neg_batch_list.reshape(-1)
        neg_valid = batch.neg_batch_list != PADDED_NODE_ID
        pair_rows = {}
        if rows is not None:
            # Each candidate's adjacency row is its own seed row.
            lut = seed_lookup(batch.seed_nids[0], num_nodes)
            cand_r, found = candidate_rows(lut, negs, rows.shape[0])
            pair_rows = dict(rows_i=torch.cat([rows[:B], rows[:B].repeat_interleave(Q, 0)]),
                             rows_j=torch.cat([rows[B : 2 * B], rows[cand_r.long()]]))
            neg_valid = neg_valid & found.reshape(B, Q)
        xs = features(z, last_upd, sub, batch,
                      torch.cat([batch.edge_src, batch.edge_src.repeat_interleave(Q)]),
                      torch.cat([batch.edge_dst, negs]),
                      torch.cat([batch.edge_time, batch.edge_time.repeat_interleave(Q)]),
                      **pair_rows)
        scores = decoder.xsmlp(xs).reshape(-1)
        pos, neg = scores[:B], scores[B:].reshape(B, Q)
        neg = tie_equal_candidates(pos, neg, xs[:B], xs[B:].reshape(B, Q, -1))
        sums = mrr_sum_count(pos, neg, neg_valid=neg_valid, edge_valid=batch.edge_valid)
        return tgn_eval_commit(memory, mem_state, batch, num_nodes), sums

    train_core.loss_and_grad = loss_and_grad
    train_core.commit = commit
    return train_core, eval_core


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = base_parser("TNCN LinkPropPred Example")
    p.add_argument("--n-nbrs", type=int, nargs="+", default=[10])
    p.add_argument("--time-dim", type=int, default=100)
    p.add_argument("--embed-dim", type=int, default=100)
    p.add_argument("--memory-dim", type=int, default=100)
    p.add_argument("--ncn-k", type=int, default=2, choices=[2, 4, 8])
    p.add_argument("--cn-time-decay", action="store_true")
    return p.parse_args(argv)


def build(args: argparse.Namespace, data=None, cands=None) -> SimpleNamespace:
    """The example's setup (``setup_linkpred``), hooks, modules, optimizer,
    cores, dropout generator and memory on ``args.device``; ``data`` and
    ``cands`` (val and test candidates) replace the dataset ``args.dataset``
    names."""
    setup = setup_linkpred(args, data=data, cands=cands)
    num_nodes, edge_dim, dev = setup.num_nodes, setup.edge_dim, setup.device
    recency = RecencyNeighborHook(num_nodes, args.n_nbrs, ["edge_src", "edge_dst", "neg"],
                                  ["edge_time", "edge_time", "neg_time"], edge_dim=edge_dim,
                                  device=dev)
    setup.hm.register_shared(recency)
    setup.hm.register_shared(DeduplicationHook(num_nodes, seed_nodes_keys=["neg", "nbr_nids"]))

    memory = TGNMemory(num_nodes, edge_dim, args.memory_dim, args.time_dim).to(dev)
    encoder = GraphAttentionEmbedding(args.memory_dim, args.embed_dim, edge_dim, args.time_dim,
                                      dropout=args.dropout).to(dev)
    decoder = NCNPredictor(args.embed_dim, args.embed_dim, 1, k=args.ncn_k,
                           cn_time_decay=args.cn_time_decay).to(dev)
    opt = torch.optim.Adam([p for m in (memory, encoder, decoder) for p in m.parameters()],
                           lr=args.lr)
    train_core, eval_core = build_tncn_cores(memory, encoder, decoder, opt, num_nodes)
    return SimpleNamespace(setup=setup, hm=setup.hm, dgs=setup.dgs, streams=setup.streams,
                           recency=recency, memory=memory, encoder=encoder, decoder=decoder,
                           opt=opt, train_core=train_core, eval_core=eval_core,
                           mem=memory.init_state(dev),
                           generator=torch.Generator(device=dev).manual_seed(args.seed))


def batch_fn(ctx: SimpleNamespace, core: str) -> Callable:
    """The per-batch step of ``core`` ("train": the loss, on ``ctx``'s
    generator; "eval": (mrr_sum, mrr_count)), reading and writing
    ``ctx.mem``."""
    if core == "train":
        def train_batch(batch):
            (ctx.mem, ctx.generator), loss = ctx.train_core((ctx.mem, ctx.generator), batch)
            return loss

        return train_batch

    def eval_batch(batch):
        ctx.mem, sums = ctx.eval_core(ctx.mem, batch)
        return sums

    return eval_batch


def hooks(ctx: SimpleNamespace) -> Dict[str, Callable[[], None]]:
    """``run_epochs``' hooks: a fresh memory at each epoch's start,
    ``flush_all`` at train's end."""

    def on_epoch_start():
        ctx.mem = ctx.memory.init_state(ctx.setup.device)

    def on_train_end():
        ctx.mem = ctx.memory.flush_all(ctx.mem)

    return {"on_epoch_start": on_epoch_start, "on_train_end": on_train_end}


def run(ctx: SimpleNamespace, args: argparse.Namespace,
        on_epoch_end: Optional[Callable[[int], None]] = None) -> Dict[str, list]:
    """The example's epochs, then test (``run_epochs``); returns each epoch's
    per-batch losses, mean loss and val MRR, and the test MRR.
    ``on_epoch_end(e)`` runs after epoch ``e``'s val."""
    return run_epochs(ctx.setup, args, batch_fn(ctx, "train"), batch_fn(ctx, "eval"),
                      on_epoch_end=on_epoch_end, **hooks(ctx))


def main(argv: Optional[List[str]] = None) -> Dict[str, list]:
    args = parse_args(argv)
    return run(build(args), args)


if __name__ == "__main__":
    main()
