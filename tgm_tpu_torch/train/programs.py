"""Per-batch serving programs (port of ``tgm_tpu/train/programs.py`` and of
the DyGFormer example's ``eval_core``).

* TGN: stored memory of the seeds and their recency neighbours, rowwise
  attention, ``LinkPredictor`` scores of the positives and the TGB
  candidates, TGB MRR, then the eval-mode memory commit (store messages,
  then flush).
* DyGFormer: the recency neighbour sequences of each (src, dst) and (src,
  candidate) pair through the encoder, ``LinkPredictor`` scores, TGB MRR.

Inference only; the train steps are later slices of the port (ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..constants import PADDED_NODE_ID
from ..eval.metrics import mrr_sum_count
from ..hooks.dedup import candidate_rows, seed_lookup
from ..nn.encoder.tgn import TGNMemory, TGNMemoryState, tgn_store_messages


def _raw_msg(batch) -> torch.Tensor:
    if batch.has("edge_x"):
        return batch.edge_x
    return torch.zeros((batch.edge_src.shape[0], 0), device=batch.edge_src.device)


def _batch_nodes(batch, num_nodes: int) -> torch.Tensor:
    nodes = torch.cat([batch.edge_src, batch.edge_dst])
    return torch.where(torch.cat([batch.edge_valid, batch.edge_valid]), nodes, num_nodes)


def tgn_eval_commit(memory: TGNMemory, mem_state: TGNMemoryState, batch,
                    num_nodes: int) -> TGNMemoryState:
    """Eval-mode memory update: store this batch's messages, THEN apply them
    (the reverse of the train-mode order)."""
    mem_state = tgn_store_messages(
        mem_state, batch.edge_src, batch.edge_dst, batch.edge_time,
        _raw_msg(batch), batch.edge_valid,
    )
    return memory.flush(mem_state, _batch_nodes(batch, num_nodes))


def build_tgn_hook_cores(
    memory: TGNMemory,
    encoder: Any,
    decoder: Any,
    num_nodes: int,
    style: str = "rowwise",
    train: bool = False,
) -> Callable:
    """Return the rowwise ``eval_core``.

    ``eval_core(mem_state, batch) -> (mem_state, (mrr_sum, mrr_count))``,
    with batches carrying the TGB hook's ``neg``/``neg_batch_list`` and the
    recency hook's ``seed_nids``/``nbr_*`` products, seeds laid out
    [src | dst | unique candidates]. The memory state is updated in place.
    """
    if style != "rowwise":
        raise NotImplementedError(
            f"style={style!r}: only the rowwise cores are ported; the segment style "
            "is queued in ROADMAP.md"
        )
    if train:
        raise NotImplementedError(
            "the TGN train step (BCE, Adam, random negatives, tgn_train_commit) is the "
            "next slice of the port; see ROADMAP.md"
        )

    def encode(mem_state, batch):
        seeds = batch.seed_nids[0]  # (S,)
        nbrs = batch.nbr_nids[0]  # (S, K)
        S, K = nbrs.shape
        rows = torch.cat([seeds, nbrs.reshape(-1)])
        z_mem, last_upd = memory.stage(mem_state, rows, training=False)
        M = z_mem.shape[-1]
        return encoder(
            z_mem[:S], z_mem[S:].reshape(S, K, M), last_upd[:S],
            batch.nbr_edge_time[0], batch.nbr_edge_x[0], nbrs != PADDED_NODE_ID,
        )

    @torch.no_grad()
    def eval_core(mem_state, batch):
        B = batch.edge_src.shape[0]
        Q = batch.neg_batch_list.shape[1]
        z = encode(mem_state, batch)
        # Candidates live in the trailing unique-candidate seed section;
        # locate each candidate's row through the seed lookup.
        lut = seed_lookup(batch.seed_nids[0], num_nodes)
        rows_c, found = candidate_rows(lut, batch.neg_batch_list, z.shape[0])
        # Positives and candidates go through ONE decoder call (the JAX code
        # makes two). Exact ties are common (nodes without history share one
        # embedding), and one matmul scores equal rows equally on every
        # device, where two matmuls of different shapes may round apart.
        z_src = z[:B][:, None, :].expand(B, Q + 1, z.shape[1]).reshape(B * (Q + 1), -1)
        z_dst = torch.cat([z[B : 2 * B][:, None, :], z[rows_c.long()]], dim=1)
        scores = decoder(z_src, z_dst.reshape(B * (Q + 1), -1)).reshape(B, Q + 1)
        pos_score, neg_score = scores[:, 0], scores[:, 1:]
        s, c = mrr_sum_count(
            pos_score, neg_score,
            neg_valid=(batch.neg_batch_list != PADDED_NODE_ID) & found,
            edge_valid=batch.edge_valid,
        )
        mem_state = tgn_eval_commit(memory, mem_state, batch, num_nodes)
        return mem_state, (s, c)

    return eval_core


def build_dygformer_eval_core(encoder: Any, decoder: Any, node_x: torch.Tensor,
                             num_nodes: int) -> Callable:
    """Return the DyGFormer ``eval_core(carry, batch) -> (carry, (mrr_sum, mrr_count))``.

    Counterpart of ``examples/linkproppred/dygformer.py::eval_core``. Batches
    carry the TGB hook's ``neg_batch_list`` and the recency hook's
    ``seed_nids`` / ``nbr_*`` products (either recency layout), seeds laid out
    [src | dst | unique candidates]. Each candidate's neighbour rows are found
    through the seed lookup; the src rows are repeated Q times. The carry is
    passed through untouched. The stack's weights are converted once, here.

    The returned core has two attributes: ``embed(batch) -> (z_src, z_dst)``
    for the B * (Q + 1) pairs, positives first, and ``score(batch, z_src,
    z_dst) -> (mrr_sum, mrr_count)``; ``eval_core`` is ``score`` of ``embed``.
    """
    stack = encoder.stack_weights()

    def embed(batch):
        B = batch.edge_src.shape[0]
        Q = batch.neg_batch_list.shape[1]
        nbr = batch.nbr_nids[0]
        negs = batch.neg_batch_list.reshape(-1)
        lut = seed_lookup(batch.seed_nids[0], num_nodes)
        rows_c, _ = candidate_rows(lut, negs, nbr.shape[0])
        # Positives and candidates go through ONE encoder call of B * (Q + 1)
        # pairs (the JAX code makes two), so equal pairs get equal embeddings
        # on every device.
        b = torch.arange(B, device=nbr.device)
        src_rows = torch.cat([b, b.repeat_interleave(Q)])
        rows = torch.cat([src_rows, B + b, rows_c.long()])
        seeds_a = batch.edge_src[src_rows]
        seeds_b = torch.cat([batch.edge_dst, negs])
        times = batch.edge_time[src_rows]
        return encoder(node_x, seeds_a, seeds_b, times, nbr[rows], batch.nbr_edge_time[0][rows],
                       batch.nbr_edge_x[0][rows], stack=stack)

    def score(batch, z_src, z_dst):
        B = batch.edge_src.shape[0]
        Q = batch.neg_batch_list.shape[1]
        lut = seed_lookup(batch.seed_nids[0], num_nodes)
        _, found = candidate_rows(lut, batch.neg_batch_list, batch.nbr_nids[0].shape[0])
        scores = decoder(z_src, z_dst)  # one decoder call, as for the TGN core
        return mrr_sum_count(
            scores[:B], scores[B:].reshape(B, Q),
            neg_valid=(batch.neg_batch_list != PADDED_NODE_ID) & found,
            edge_valid=batch.edge_valid,
        )

    @torch.no_grad()
    def eval_core(carry, batch):
        return carry, score(batch, *embed(batch))

    eval_core.embed = torch.no_grad()(embed)
    eval_core.score = torch.no_grad()(score)
    return eval_core


__all__ = ["build_dygformer_eval_core", "build_tgn_hook_cores", "tgn_eval_commit"]
