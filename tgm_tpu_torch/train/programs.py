"""Per-batch programs (port of ``tgm_tpu/train/programs.py`` and of the
DyGFormer example's ``train_core`` and ``eval_core``).

* TGN train, rowwise: staged memory of the seeds [src | dst | neg] and their
  recency neighbours, rowwise attention with dropout, ``LinkPredictor``
  scores of the positives and the random negatives, masked BCE, backward,
  then the train-mode memory commit (commit the staged src/dst rows, then
  store the messages) with the old parameters, then the optimizer step.
* TGN train, segment (the reference example's formulation): staged memory
  of the batch's deduplicated nodes, the segment ``GraphAttentionEmbedding``
  over the (seed -> neighbour) local edges, the same loss, then the
  train-mode commit through ``flush`` with the old parameters, then the
  optimizer step.
* TGN eval: stored memory of the seeds and their recency neighbours (or of
  the deduplicated nodes), the encoder, ``LinkPredictor`` scores of the
  positives and the TGB candidates, TGB MRR, then the eval-mode memory
  commit (store messages, then flush).
* DyGFormer train: the recency neighbour sequences of each (src, dst) and
  (src, random negative) pair through the encoder with dropout,
  ``LinkPredictor`` scores, masked BCE, backward, the optimizer step.
* DyGFormer eval: the recency neighbour sequences of each (src, dst) and
  (src, candidate) pair through the encoder, ``LinkPredictor`` scores, TGB
  MRR.
* TGAT train (``examples/linkproppred/tgat.py``): the multi-hop recency
  neighbourhoods of [src | dst | neg] through TGAT with dropout,
  ``LinkPredictor`` scores, masked BCE, backward, the optimizer step.
* TGAT eval: TGAT embeddings of [src | dst | unique candidates], each
  candidate's row found through the seed lookup, ``LinkPredictor`` scores,
  TGB MRR.
* TPNet train (``examples/linkproppred/tpnet.py``): the (src, dst) and
  (src, neg) recency rows through TPNet with dropout, both calls drawing
  the same masks, ``LinkPredictor``, masked BCE, backward, then
  ``rp_update`` with the batch's edges, then the optimizer step.
* TPNet eval: the (src, dst) pairs, then every (src, candidate) pair (the
  candidate's recency rows found through the seed lookup), ``LinkPredictor``
  scores, TGB MRR, then ``rp_update``.
* TPNet node property prediction (``examples/nodeproppred/tpnet.py``):
  each label node paired with itself, ``NodePredictor`` logits,
  soft-label cross-entropy and the optimizer step, or NDCG@k; then
  ``rp_update`` with the batch's edges.
* TGN node property prediction (``examples/nodeproppred/tgn.py``): memory
  staged (train mode, in train and eval alike) over the batch's
  deduplicated nodes, the segment ``GraphAttentionEmbedding`` over the
  (label node -> recency neighbour) edges, ``NodePredictor`` logits of the
  label nodes' rows, soft-label cross-entropy or NDCG@k, then the
  train-order commit (flush, then store) with the old parameters, then the
  optimizer step; a batch without labels moves neither the weights nor the
  optimizer's state.
* TGAT node property prediction (``examples/nodeproppred/tgat.py``): TGAT
  embeddings of the label nodes with dropout, ``NodePredictor`` logits,
  soft-label cross-entropy and the optimizer step on every batch, or
  NDCG@k.

The memory state is updated in place. ``tgn_embed``, ``tgn_loss_and_grad``
and ``score_candidates`` are the steps the hook cores share with
``train/tgn_pipeline.py``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from ..constants import DEFAULT_NDCG_K, PADDED_NODE_ID
from ..eval.metrics import mrr_sum_count, ndcg_at_k
from ..hooks.dedup import candidate_rows, local_rows, map_to_local, seed_lookup
from ..nn.encoder.tgn import TGNMemory, tgn_commit_staged
from ..nn.encoder.tpnet import rp_update


def bce_with_logits(logits: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                    denom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``optax.sigmoid_binary_cross_entropy``, summed over ``mask`` and divided
    by ``denom`` (default: the mask's count, at least 1; a sharded step gives
    the whole batch's)."""
    loss = -target * F.logsigmoid(logits) - (1.0 - target) * F.logsigmoid(-logits)
    w = mask.to(loss.dtype)
    return (loss * w).sum() / (w.sum().clamp_min(1.0) if denom is None else denom)


def _raw_msg(batch) -> torch.Tensor:
    if batch.has("edge_x"):
        return batch.edge_x
    return torch.zeros((batch.edge_src.shape[0], 0), device=batch.edge_src.device)


def _batch_nodes(batch, num_nodes: int) -> torch.Tensor:
    nodes = torch.cat([batch.edge_src, batch.edge_dst])
    return torch.where(torch.cat([batch.edge_valid, batch.edge_valid]), nodes, num_nodes)


def zero_every_grad(opt: torch.optim.Optimizer) -> None:
    """Zero ``opt``'s gradients in place, giving every parameter one, so that
    every parameter steps every time, as optax updates every leaf (Adam's
    moments decay and its step count keeps pace)."""
    opt.zero_grad(set_to_none=False)
    for group in opt.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)


def tgn_train_commit(memory: TGNMemory, mem_state, batch, num_nodes: int,
                     staged: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Train-mode memory update: apply the pending messages of the batch's
    src and dst nodes, THEN store this batch's messages, in place.

    ``staged``: the (memory, last_update) rows the forward staged for the
    batch's src | dst seeds, which equal what ``flush`` would compute, so
    committing them skips re-running the GRU; without it the nodes are
    flushed. ``memory.store`` picks the store by aggregator and layout.
    """
    nodes = _batch_nodes(batch, num_nodes)
    if staged is not None:
        mem_state = tgn_commit_staged(mem_state, nodes, *staged)
    else:
        mem_state = memory.flush(mem_state, nodes)
    return memory.store(mem_state, batch.edge_src, batch.edge_dst, batch.edge_time,
                        _raw_msg(batch), batch.edge_valid)


def tgn_eval_commit(memory: TGNMemory, mem_state, batch, num_nodes: int):
    """Eval-mode memory update: store this batch's messages, THEN apply them
    (the reverse of the train-mode order)."""
    mem_state = memory.store(mem_state, batch.edge_src, batch.edge_dst, batch.edge_time,
                             _raw_msg(batch), batch.edge_valid)
    return memory.flush(mem_state, _batch_nodes(batch, num_nodes))


def local_edges(g2l: torch.Tensor, seeds: torch.Tensor, nbrs: torch.Tensor,
                nbr_time: torch.Tensor, nbr_x: torch.Tensor):
    """The (seed -> neighbour) edges of S seeds' (S, K) recency neighbours in
    the local ids of the dense table ``g2l``: ``(e_src, e_dst, e_t, e_x,
    valid)`` over the S * K slots, valid where neither end is PAD."""
    src_rep = seeds.repeat_interleave(nbrs.shape[1])
    nbr_flat = nbrs.reshape(-1)
    valid = (nbr_flat != PADDED_NODE_ID) & (src_rep != PADDED_NODE_ID)
    return (map_to_local(g2l, src_rep), map_to_local(g2l, nbr_flat), nbr_time.reshape(-1),
            nbr_x.reshape(nbr_flat.shape[0], -1), valid)


def build_local_edges(batch, num_nodes: int):
    """``local_edges`` of a batch's recency products through the dedup
    hook's table, as the reference example builds them; unseen ids map to
    -1."""
    return local_edges(batch.global_to_local, batch.seed_nids[0], batch.nbr_nids[0],
                       batch.nbr_edge_time[0], batch.nbr_edge_x[0])


def tgn_embed(memory: TGNMemory, encoder: Any, mem_state,
              seeds: torch.Tensor, nbrs: torch.Tensor, nbr_time: torch.Tensor,
              nbr_x: torch.Tensor, training: bool, generator: Optional[torch.Generator] = None,
              nbr_msg_proj: Optional[torch.Tensor] = None,
              stage: Optional[Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]] = None):
    """Rowwise TGN embeddings of S seeds over their (S, K) recency neighbours.

    Stages memory for [seeds | neighbours] (train mode) or reads the stored
    rows (eval mode) and runs the encoder. Returns ``(z, (z_mem,
    last_update))`` with the memory rows of the S + S * K staged ids.
    ``stage(ids)``, where given, replaces ``memory.stage(mem_state, ids,
    training)`` (the node-sharded step stages rows fetched from their owners).
    """
    S, K = nbrs.shape
    rows = torch.cat([seeds, nbrs.reshape(-1)])
    if stage is None:
        z_mem, last_upd = memory.stage(mem_state, rows, training=training)
    else:
        z_mem, last_upd = stage(rows)
    M = z_mem.shape[-1]
    z = encoder(
        z_mem[:S], z_mem[S:].reshape(S, K, M), last_upd[:S], nbr_time, nbr_x,
        nbrs != PADDED_NODE_ID, generator=generator, nbr_msg_proj=nbr_msg_proj,
    )
    return z, (z_mem, last_upd)


def tgn_loss_and_grad(memory: TGNMemory, encoder: Any, decoder: Any,
                      opt: torch.optim.Optimizer, mem_state,
                      seeds: torch.Tensor, nbrs: torch.Tensor, nbr_time: torch.Tensor,
                      nbr_x: torch.Tensor, edge_valid: torch.Tensor,
                      generator: Optional[torch.Generator] = None, stage=None,
                      denom: Optional[torch.Tensor] = None):
    """Masked BCE of a train batch and its backward; returns ``(loss, staged)``.

    Seeds are laid out [src | dst | neg], B each. ``opt``'s gradients are
    zeroed in place and every parameter gets one, so every parameter steps
    every time, as optax updates every leaf. ``loss`` is detached;
    ``staged`` holds the staged (memory, last_update) rows of src | dst, the
    train-mode commit set. ``stage`` goes to ``tgn_embed``, ``denom`` to
    ``bce_with_logits``.
    """
    B = edge_valid.shape[0]
    zero_every_grad(opt)
    with torch.enable_grad():
        z, (st_mem, st_last) = tgn_embed(memory, encoder, mem_state, seeds, nbrs, nbr_time,
                                         nbr_x, True, generator, stage=stage)
        pos = decoder(z[:B], z[B : 2 * B])
        neg = decoder(z[:B], z[2 * B : 3 * B])
        loss = bce_with_logits(pos, torch.ones_like(pos), edge_valid, denom) + bce_with_logits(
            neg, torch.zeros_like(neg), edge_valid, denom
        )
        loss.backward()
    return loss.detach(), (st_mem[: 2 * B].detach(), st_last[: 2 * B])


def score_candidates(decoder: Any, z_src: torch.Tensor, z_dst: torch.Tensor,
                     z_cand: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B,) positive and (B, Q) candidate scores of each src row, in ONE
    decoder call of B * (Q + 1) rows (the JAX code makes two). Exact ties
    are common (nodes without history share one embedding), and one matmul
    scores equal rows equally on every device, where two matmuls of
    different shapes may round apart."""
    B, Q, D = z_cand.shape
    src = z_src[:, None, :].expand(B, Q + 1, D).reshape(B * (Q + 1), D)
    dst = torch.cat([z_dst[:, None, :], z_cand], dim=1).reshape(B * (Q + 1), D)
    scores = decoder(src, dst).reshape(B, Q + 1)
    return scores[:, 0], scores[:, 1:]


def tie_equal_candidates(pos: torch.Tensor, negs: torch.Tensor, z_dst: torch.Tensor,
                         z_cand: torch.Tensor) -> torch.Tensor:
    """``negs`` with the positive's score wherever a candidate's embedding
    equals the positive's bit for bit: the decoder's input is the same, but
    a matmul may round equal rows apart by their position (ROADMAP.md fault
    8)."""
    same = (z_cand == z_dst[:, None, :]).all(dim=-1)
    return torch.where(same, pos[:, None], negs)


def score_seed_rows(decoder: Any, batch, z: torch.Tensor,
                    num_nodes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """TGB ``(mrr_sum, mrr_count)`` of a batch from one embedding row per hook
    seed, [src | dst | unique candidates]: each candidate's row is found
    through the seed lookup, positives and candidates are scored in one
    decoder call, and a candidate whose embedding equals the positive's ties
    with it."""
    B = batch.edge_src.shape[0]
    lut = seed_lookup(batch.seed_nids[0], num_nodes)
    rows_c, found = candidate_rows(lut, batch.neg_batch_list, z.shape[0])
    z_dst, z_cand = z[B : 2 * B], z[rows_c.long()]
    pos, negs = score_candidates(decoder, z[:B], z_dst, z_cand)
    negs = tie_equal_candidates(pos, negs, z_dst, z_cand)
    return mrr_sum_count(
        pos, negs,
        neg_valid=(batch.neg_batch_list != PADDED_NODE_ID) & found,
        edge_valid=batch.edge_valid,
    )


def score_dedup_rows(decoder: Any, batch, z: torch.Tensor):
    """TGB ``(mrr_sum, mrr_count)`` of a batch from one embedding row per
    unique node of the dedup hook (``z`` (U, D)), scored as
    ``score_candidates`` and ``tie_equal_candidates`` score them; returns it
    with the (B, D) src and dst rows. An id the dedup table lacks reads row
    U - 1, as a JAX gather wraps -1."""
    B, Q = batch.neg_batch_list.shape
    rows = lambda ids: z[local_rows(batch.global_to_local, ids, z.shape[0])]
    z_src, z_dst = rows(batch.edge_src), rows(batch.edge_dst)
    z_cand = rows(batch.neg_batch_list.reshape(-1)).reshape(B, Q, -1)
    pos, negs = score_candidates(decoder, z_src, z_dst, z_cand)
    negs = tie_equal_candidates(pos, negs, z_dst, z_cand)
    sums = mrr_sum_count(pos, negs, neg_valid=batch.neg_batch_list != PADDED_NODE_ID,
                         edge_valid=batch.edge_valid)
    return sums, (z_src, z_dst)


def train_loss_and_grad(opt: torch.optim.Optimizer, embed: Callable[[], torch.Tensor],
                        decoder: Any, edge_valid: torch.Tensor,
                        denom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked BCE of one train batch and its backward; returns the detached loss.

    ``embed()`` gives the embeddings of [src | dst | neg], B rows each.
    ``opt``'s gradients are zeroed in place and every parameter gets one
    (``zero_every_grad``). ``denom`` goes to ``bce_with_logits``."""
    B = edge_valid.shape[0]
    zero_every_grad(opt)
    with torch.enable_grad():
        z = embed()
        pos = decoder(z[:B], z[B : 2 * B])
        neg = decoder(z[:B], z[2 * B : 3 * B])
        loss = bce_with_logits(pos, torch.ones_like(pos), edge_valid, denom) + bce_with_logits(
            neg, torch.zeros_like(neg), edge_valid, denom
        )
        loss.backward()
    return loss.detach()


def build_tgn_hook_cores(
    memory: TGNMemory,
    encoder: Any,
    decoder: Any,
    opt: Optional[torch.optim.Optimizer],
    num_nodes: int,
    style: str = "segment",
) -> Tuple[Callable, Callable]:
    """Return ``(train_core, eval_core)``.

    * ``train_core((mem_state, generator), batch) -> ((mem_state, generator),
      loss)``; the JAX carry ``(params, opt_state, mem_state, rng)`` maps to
      the modules' parameters, ``opt``'s state, ``mem_state`` and the
      ``torch.Generator`` that draws the attention dropout (``None``: no
      dropout). ``loss`` is detached. Batches carry the random-negative
      hook's ``neg`` (B ids) and the recency hook's products, seeds laid out
      [src | dst | neg].
    * ``eval_core(mem_state, batch) -> (mem_state, (mrr_sum, mrr_count))``;
      the JAX carry ``(params, mem_state)`` maps to the modules' parameters
      and ``mem_state``. Batches carry the TGB hook's ``neg``/``neg_batch_list``
      and the recency hook's products, seeds laid out [src | dst | unique
      candidates]. No dropout, whatever the modules' train/eval mode.

    ``style`` picks the attention wiring:

    * ``"segment"`` (the default, the reference example's formulation):
      pass a ``GraphAttentionEmbedding``; batches also carry the dedup
      hook's ``unique_nids`` and ``global_to_local``. Memory is staged over
      the unique nodes and the train commit flushes the batch's nodes.
    * ``"rowwise"``: pass a ``GraphAttentionEmbeddingRowwise``; each seed
      attends over its own K neighbours, and the train commit writes the
      rows the forward staged.

    ``opt`` is an optimizer over the three modules' parameters (``None`` for
    eval-only callers; ``train_core`` then raises); see ``zero_every_grad``
    for its gradients. ``train_core.loss_and_grad(mem_state, batch,
    generator) -> (loss, staged)`` and ``train_core.commit(mem_state, batch,
    staged)`` are its first two stages (``staged`` is ``None`` for the
    segment style); ``opt.step()`` is the third.
    """
    if style not in ("segment", "rowwise"):
        raise ValueError(f"Unknown style: {style!r}")

    def require_opt():
        if opt is None:
            raise ValueError("train_core needs an optimizer: build the cores with opt")

    if style == "segment":
        def embed(mem_state, batch, training, generator=None):
            z_mem, last_upd = memory.stage(mem_state, batch.unique_nids, training=training)
            return encoder(z_mem, last_upd, *build_local_edges(batch, num_nodes),
                           generator=generator)

        def loss_and_grad(mem_state, batch, generator):
            require_opt()

            def seed_rows():
                z = embed(mem_state, batch, True, generator)
                ids = torch.cat([batch.edge_src, batch.edge_dst, batch.neg])
                return z[local_rows(batch.global_to_local, ids, z.shape[0])]

            return train_loss_and_grad(opt, seed_rows, decoder, batch.edge_valid), None

        @torch.no_grad()
        def eval_core(mem_state, batch):
            (s, c), _ = score_dedup_rows(decoder, batch, embed(mem_state, batch, False))
            return tgn_eval_commit(memory, mem_state, batch, num_nodes), (s, c)
    else:
        def hook_products(batch):
            return (batch.seed_nids[0], batch.nbr_nids[0], batch.nbr_edge_time[0],
                    batch.nbr_edge_x[0])

        def loss_and_grad(mem_state, batch, generator):
            require_opt()
            return tgn_loss_and_grad(memory, encoder, decoder, opt, mem_state,
                                     *hook_products(batch), batch.edge_valid, generator)

        @torch.no_grad()
        def eval_core(mem_state, batch):
            B = batch.edge_src.shape[0]
            z, _ = tgn_embed(memory, encoder, mem_state, *hook_products(batch), False)
            # Candidates live in the trailing unique-candidate seed section;
            # locate each candidate's row through the seed lookup.
            lut = seed_lookup(batch.seed_nids[0], num_nodes)
            rows_c, found = candidate_rows(lut, batch.neg_batch_list, z.shape[0])
            pos_score, neg_score = score_candidates(decoder, z[:B], z[B : 2 * B],
                                                    z[rows_c.long()])
            s, c = mrr_sum_count(
                pos_score, neg_score,
                neg_valid=(batch.neg_batch_list != PADDED_NODE_ID) & found,
                edge_valid=batch.edge_valid,
            )
            mem_state = tgn_eval_commit(memory, mem_state, batch, num_nodes)
            return mem_state, (s, c)

    def commit(mem_state, batch, staged):
        return tgn_train_commit(memory, mem_state, batch, num_nodes, staged)

    def train_core(carry, batch):
        mem_state, generator = carry
        loss, staged = loss_and_grad(mem_state, batch, generator)
        # The reference order: the commit runs with the old parameters,
        # before the optimizer step.
        mem_state = commit(mem_state, batch, staged)
        opt.step()
        return (mem_state, generator), loss

    train_core.loss_and_grad = loss_and_grad
    train_core.commit = commit
    return train_core, eval_core


def build_dygformer_train_core(encoder: Any, decoder: Any, opt: torch.optim.Optimizer,
                               node_x: torch.Tensor, pairs: str = "split") -> Callable:
    """Return the DyGFormer ``train_core(carry, batch) -> (carry, loss)``.

    Counterpart of the ``train_core`` of ``examples/linkproppred/dygformer.py``
    (``pairs="split"``: two encoder calls, (src, dst) and (src, neg)) and of
    ``bench.py``'s ``--dyg-pairs fused`` (``pairs="fused"``: one
    ``encode_pairs`` call). The JAX carry ``(params, opt_state, rng)`` maps
    to the modules' parameters, ``opt``'s state and the carry ``(generator,)``:
    the ``torch.Generator`` that draws the dropout masks (``None``: no
    dropout). Both pair calls of a step draw the same masks, as the JAX
    example passes one key to both: the generator's state is restored before
    the second call. Batches carry the random-negative hook's ``neg`` (B ids)
    and the recency hook's products, seeds laid out [src | dst | neg]. The
    stack runs through the layers' modules (autograd). The loss, masked BCE
    of the positives and the negatives, is detached; every parameter gets a
    gradient (``zero_every_grad``) before ``opt.step()``.

    ``train_core.loss_and_grad(batch, generator) -> loss`` is its first
    stage; ``opt.step()`` is the second.
    """
    if pairs not in ("split", "fused"):
        raise ValueError(f"pairs must be 'split' or 'fused', got {pairs!r}")

    def embed(batch, generator):
        B = batch.edge_src.shape[0]
        nbr, nt, nx = batch.nbr_nids[0], batch.nbr_edge_time[0], batch.nbr_edge_x[0]
        kw = dict(deterministic=generator is None, generator=generator)
        if pairs == "fused":
            return encoder.encode_pairs(node_x, batch.edge_src, batch.edge_dst, batch.neg,
                                        batch.edge_time, nbr, nt, nx, **kw)
        neg_rows = lambda x: torch.cat([x[:B], x[2 * B:]])  # (src, neg) pairs
        state = None if generator is None else generator.get_state()
        zs, zd = encoder(node_x, batch.edge_src, batch.edge_dst, batch.edge_time, nbr[:2 * B],
                         nt[:2 * B], nx[:2 * B], **kw)
        if state is not None:
            generator.set_state(state)
        zs2, zn = encoder(node_x, batch.edge_src, batch.neg, batch.edge_time, neg_rows(nbr),
                          neg_rows(nt), neg_rows(nx), **kw)
        return zs, zd, zs2, zn

    def loss_and_grad(batch, generator):
        zero_every_grad(opt)
        with torch.enable_grad():
            zs, zd, zs2, zn = embed(batch, generator)
            pos = decoder(zs, zd)
            neg = decoder(zs2, zn)
            loss = bce_with_logits(pos, torch.ones_like(pos), batch.edge_valid) + bce_with_logits(
                neg, torch.zeros_like(neg), batch.edge_valid
            )
            loss.backward()
        return loss.detach()

    def train_core(carry, batch):
        (generator,) = carry
        loss = loss_and_grad(batch, generator)
        opt.step()
        return (generator,), loss

    train_core.loss_and_grad = loss_and_grad
    return train_core


def build_dygformer_eval_core(encoder: Any, decoder: Any, node_x: torch.Tensor,
                             num_nodes: int, stack: str = "kernel") -> Callable:
    """Return the DyGFormer ``eval_core(carry, batch) -> (carry, (mrr_sum, mrr_count))``.

    Counterpart of ``examples/linkproppred/dygformer.py::eval_core``. Batches
    carry the TGB hook's ``neg_batch_list`` and the recency hook's
    ``seed_nids`` / ``nbr_*`` products (either recency layout), seeds laid out
    [src | dst | unique candidates]. Each candidate's neighbour rows are found
    through the seed lookup; the src rows are repeated Q times. The carry is
    passed through untouched. No dropout, whatever the modules' mode.

    ``stack="kernel"`` runs the transformer stack through K5 (its plain
    version on the CPU), as ``bench.py --dyg-stack pallas`` does; the
    weights are converted once, here, so a train loop rebuilds the core
    after each epoch's optimizer steps, before it evaluates.
    ``stack="module"`` runs the layers' modules, as the JAX example's eval.

    The returned core has two attributes: ``embed(batch) -> (z_src, z_dst)``
    for the B * (Q + 1) pairs, positives first, and ``score(batch, z_src,
    z_dst) -> (mrr_sum, mrr_count)``; ``eval_core`` is ``score`` of ``embed``.
    """
    if stack not in ("kernel", "module"):
        raise ValueError(f"stack must be 'kernel' or 'module', got {stack!r}")
    weights = encoder.stack_weights() if stack == "kernel" else None

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
                       batch.nbr_edge_x[0][rows], stack=weights)

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


def _tgat_embed(encoder: Any, node_x: torch.Tensor, batch,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    return encoder(node_x, batch.seed_nids, batch.seed_times, batch.nbr_nids, batch.nbr_edge_x,
                   batch.nbr_edge_time, generator=generator)


def build_tgat_train_core(encoder: Any, decoder: Any, opt: torch.optim.Optimizer,
                          node_x: torch.Tensor) -> Callable:
    """Return the TGAT ``train_core(carry, batch) -> (carry, loss)`` of
    ``examples/linkproppred/tgat.py``.

    The JAX carry ``(params, opt_state, rng)`` maps to the modules'
    parameters, ``opt``'s state and the carry ``(generator,)``: the
    ``torch.Generator`` that draws the dropout masks (``None``: no dropout).
    Batches carry the random-negative hook's ``neg`` (B ids) and the
    multi-hop recency hook's per-hop products, seeds laid out [src | dst |
    neg]. The loss, masked BCE of the positives and the negatives, is
    detached. ``train_core.loss_and_grad(batch, generator) -> loss`` is its
    first stage; ``opt.step()`` is the second.
    """

    def loss_and_grad(batch, generator):
        return train_loss_and_grad(opt, lambda: _tgat_embed(encoder, node_x, batch, generator),
                                   decoder, batch.edge_valid)

    def train_core(carry, batch):
        (generator,) = carry
        loss = loss_and_grad(batch, generator)
        opt.step()
        return (generator,), loss

    train_core.loss_and_grad = loss_and_grad
    return train_core


def build_tgat_eval_core(encoder: Any, decoder: Any, node_x: torch.Tensor,
                         num_nodes: int) -> Callable:
    """Return the TGAT ``eval_core(carry, batch) -> (carry, (mrr_sum, mrr_count))``
    of ``examples/linkproppred/tgat.py``.

    Batches carry the TGB hook's ``neg_batch_list`` and the recency hook's
    products, seeds laid out [src | dst | unique candidates]; each
    candidate's embedding row is found through the seed lookup. Positives
    and candidates are scored in one decoder call, and a candidate whose
    embedding equals the positive's ties with it. The carry is passed
    through untouched. No dropout, whatever the modules' mode.

    The returned core has two attributes: ``embed(batch)``, the (S_0,
    embed_dim) embeddings of the seeds, and ``score(batch, z) -> (mrr_sum,
    mrr_count)``; ``eval_core`` is ``score`` of ``embed``.
    """

    def embed(batch):
        return _tgat_embed(encoder, node_x, batch, None)

    def score(batch, z):
        return score_seed_rows(decoder, batch, z, num_nodes)

    @torch.no_grad()
    def eval_core(carry, batch):
        return carry, score(batch, embed(batch))

    eval_core.embed = torch.no_grad()(embed)
    eval_core.score = torch.no_grad()(score)
    return eval_core


def _pair_rows(batch, a: int, b: int):
    """The recency rows of seed sections ``a`` and ``b`` of [src | dst | neg]."""
    B = batch.edge_src.shape[0]
    sel = lambda x: torch.cat([x[a * B : (a + 1) * B], x[b * B : (b + 1) * B]])
    return sel(batch.nbr_nids[0]), sel(batch.nbr_edge_time[0]), sel(batch.nbr_edge_x[0])


def _rp_step(encoder: Any, rp_state, batch):
    """``rp_update`` with the batch's edges (the examples' step)."""
    return rp_update(rp_state, batch.edge_src, batch.edge_dst, batch.edge_time,
                     batch.edge_valid, encoder.random_projections.time_decay_weight)


def build_tpnet_link_cores(encoder: Any, decoder: Any, opt: Optional[torch.optim.Optimizer],
                           node_x: torch.Tensor, num_nodes: int) -> Tuple[Callable, Callable]:
    """Return the TPNet ``(train_core, eval_core)`` of
    ``examples/linkproppred/tpnet.py``; ``encoder`` is a ``TPNet`` with
    random projections.

    * ``train_core((generator, rp_state), batch) -> ((generator, rp_state),
      loss)``: the (src, dst) and (src, neg) encoder calls with dropout from
      ``generator`` (``None``: no dropout), both drawing the same masks (the
      generator's state is restored before the second, as the JAX example
      passes one key to both), the two decoder calls, masked BCE, backward;
      then ``rp_update`` with the batch's edges and the optimizer step.
    * ``eval_core(rp_state, batch) -> (rp_state, (mrr_sum, mrr_count))``: the
      (src, dst) call, then one call over the B * Q (src, candidate) pairs,
      each candidate's recency rows found through the seed lookup; TGB MRR,
      then ``rp_update``. No dropout.

    Batches carry the negative hooks' products and the one-hop recency
    hook's, seeds laid out [src | dst | neg]. ``train_core.loss_and_grad(
    batch, generator, rp_state) -> loss`` is the train core's first stage.
    """

    def loss_and_grad(batch, generator, rp_state):
        if opt is None:
            raise ValueError("train_core needs an optimizer: build the cores with opt")
        kw = dict(deterministic=generator is None, generator=generator)
        src, t = batch.edge_src, batch.edge_time
        zero_every_grad(opt)
        with torch.enable_grad():
            state = None if generator is None else generator.get_state()
            zs, zd = encoder(node_x, src, batch.edge_dst, t, *_pair_rows(batch, 0, 1), rp_state,
                             **kw)
            if state is not None:
                generator.set_state(state)
            zs2, zn = encoder(node_x, src, batch.neg, t, *_pair_rows(batch, 0, 2), rp_state, **kw)
            pos, neg = decoder(zs, zd), decoder(zs2, zn)
            loss = bce_with_logits(pos, torch.ones_like(pos), batch.edge_valid) + bce_with_logits(
                neg, torch.zeros_like(neg), batch.edge_valid
            )
            loss.backward()
        return loss.detach()

    def train_core(carry, batch):
        generator, rp_state = carry
        loss = loss_and_grad(batch, generator, rp_state)
        rp_state = _rp_step(encoder, rp_state, batch)
        opt.step()
        return (generator, rp_state), loss

    @torch.no_grad()
    def eval_core(rp_state, batch):
        B = batch.edge_src.shape[0]
        Q = batch.neg_batch_list.shape[1]
        src, t = batch.edge_src, batch.edge_time
        zs, zd = encoder(node_x, src, batch.edge_dst, t, *_pair_rows(batch, 0, 1), rp_state)
        pos = decoder(zs, zd)
        negs = batch.neg_batch_list.reshape(-1)
        nbr, nt, nx = batch.nbr_nids[0], batch.nbr_edge_time[0], batch.nbr_edge_x[0]
        lut = seed_lookup(batch.seed_nids[0], num_nodes)
        rows_c, found = candidate_rows(lut, negs, nbr.shape[0])
        rows = torch.cat([torch.arange(B, device=nbr.device).repeat_interleave(Q),
                          rows_c.long()])
        zs2, zn = encoder(node_x, src.repeat_interleave(Q), negs, t.repeat_interleave(Q),
                          nbr[rows], nt[rows], nx[rows], rp_state)
        neg = decoder(zs2, zn).reshape(B, Q)
        out = mrr_sum_count(
            pos, neg,
            neg_valid=(batch.neg_batch_list != PADDED_NODE_ID) & found.reshape(B, Q),
            edge_valid=batch.edge_valid,
        )
        return _rp_step(encoder, rp_state, batch), out

    train_core.loss_and_grad = loss_and_grad
    return train_core, eval_core


def build_tpnet_node_cores(encoder: Any, decoder: Any, opt: Optional[torch.optim.Optimizer],
                           node_x: torch.Tensor,
                           k: int = DEFAULT_NDCG_K) -> Tuple[Callable, Callable]:
    """Return the TPNet node-property ``(train_core, eval_core)`` of
    ``examples/nodeproppred/tpnet.py``.

    Each label node is paired with itself: both sides see its recency
    neighbours, and the head reads the source side's embedding.

    * ``train_core((generator, rp_state), batch) -> ((generator, rp_state),
      loss)``: the soft-label cross-entropy over ``node_y_valid`` with
      dropout from ``generator`` (``None``: no dropout), backward; then
      ``rp_update`` with the batch's edges and the optimizer step.
    * ``eval_core(rp_state, batch) -> (rp_state, ndcg)``: NDCG@k of the
      valid label rows, then ``rp_update``. No dropout.

    The caller skips a batch that carries no label fields, ``rp_update``
    included, as the JAX example does; the loader pads a batch without
    labels instead, so such a batch still steps (ROADMAP fault 19).
    ``train_core.loss_and_grad(batch, generator, rp_state) -> loss`` is the
    train core's first stage.
    """

    def logits(batch, generator, rp_state):
        nids, t = batch.node_y_nids, batch.node_y_time
        two = lambda x: torch.cat([x, x])
        zs, _ = encoder(node_x, nids, nids, t, two(batch.nbr_nids[0]),
                        two(batch.nbr_edge_time[0]), two(batch.nbr_edge_x[0]), rp_state,
                        deterministic=generator is None, generator=generator)
        return decoder(zs)

    def loss_and_grad(batch, generator, rp_state):
        if opt is None:
            raise ValueError("train_core needs an optimizer: build the cores with opt")
        return _label_loss_and_grad(opt, lambda: logits(batch, generator, rp_state), batch)

    def train_core(carry, batch):
        generator, rp_state = carry
        loss = loss_and_grad(batch, generator, rp_state)
        rp_state = _rp_step(encoder, rp_state, batch)
        opt.step()
        return (generator, rp_state), loss

    @torch.no_grad()
    def eval_core(rp_state, batch):
        ndcg = ndcg_at_k(logits(batch, None, rp_state), batch.node_y, k,
                         row_valid=batch.node_y_valid)
        return _rp_step(encoder, rp_state, batch), ndcg

    train_core.loss_and_grad = loss_and_grad
    return train_core, eval_core


def soft_label_ce(logits: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``optax.softmax_cross_entropy`` with soft labels, mean over ``mask``
    (at least 1)."""
    loss = -(target * F.log_softmax(logits, dim=-1)).sum(-1)
    w = mask.to(loss.dtype)
    return (loss * w).sum() / w.sum().clamp_min(1.0)


def has_node_labels(batch) -> bool:
    """Whether the batch holds a real label: the host count the loader and
    ``DeviceEventStream`` attach, so no step waits for the card to ask."""
    if not batch.has("num_node_labels"):
        raise ValueError("the batch carries no num_node_labels: build it with "
                         "DGDataLoader or DeviceEventStream")
    return batch.num_node_labels > 0


def _label_loss_and_grad(opt: torch.optim.Optimizer, logits: Callable[[], torch.Tensor],
                         batch) -> torch.Tensor:
    zero_every_grad(opt)
    with torch.enable_grad():
        loss = soft_label_ce(logits(), batch.node_y, batch.node_y_valid)
        loss.backward()
    return loss.detach()


def build_tgn_node_cores(memory: TGNMemory, encoder: Any, decoder: Any,
                         opt: Optional[torch.optim.Optimizer], num_nodes: int,
                         k: int = DEFAULT_NDCG_K) -> Tuple[Callable, Callable]:
    """Return the TGN node-property ``(train_core, eval_core)`` of
    ``examples/nodeproppred/tgn.py``.

    * ``train_core(mem_state, batch) -> (mem_state, (loss, has))``; the JAX
      carry ``(params, opt_state, mem_state)`` maps to the modules'
      parameters, ``opt``'s state and ``mem_state``. ``loss`` (a 0-dim
      tensor on the batch's device) is the masked soft-label cross-entropy,
      0 without labels; ``has`` is a CPU bool tensor.
    * ``eval_core(mem_state, batch) -> (mem_state, (ndcg, has))``: NDCG@k of
      the batch's valid label rows, 0 without labels.

    ``encoder`` is a ``GraphAttentionEmbedding``; batches carry the node-
    label fields, the recency hook's products seeded by ``node_y_nids`` and
    the dedup hook's ``unique_nids`` / ``global_to_local``. As in JAX:

    * memory is staged in train mode in both cores;
    * both commit in the train order (flush the batch's nodes, then store
      its messages) with the old parameters, before the optimizer step;
    * a batch without labels only commits: no forward, no backward, no
      optimizer step (JAX masks the step out with ``jnp.where``; Adam's
      step count does not advance either);
    * a label node that is neither an endpoint of the batch's edges nor
      anyone's neighbour is unseen by the dedup hook; its logits read row
      U - 1 of the embeddings, as a JAX gather at -1 does (ROADMAP.md
      fault 14).

    ``train_core.loss_and_grad(mem_state, batch) -> loss`` and
    ``train_core.commit(mem_state, batch) -> mem_state`` are its first two
    stages; ``opt.step()`` is the third.
    """

    def logits(mem_state, batch):
        z_mem, last_upd = memory.stage(mem_state, batch.unique_nids)
        z = encoder(z_mem, last_upd, *build_local_edges(batch, num_nodes))
        return decoder(z[local_rows(batch.global_to_local, batch.node_y_nids, z.shape[0])])

    def commit(mem_state, batch):
        return tgn_train_commit(memory, mem_state, batch, num_nodes)

    def loss_and_grad(mem_state, batch):
        if opt is None:
            raise ValueError("train_core needs an optimizer: build the cores with opt")
        return _label_loss_and_grad(opt, lambda: logits(mem_state, batch), batch)

    def train_core(mem_state, batch):
        has = has_node_labels(batch)
        if has:
            loss = loss_and_grad(mem_state, batch)
        else:
            loss = torch.zeros((), device=batch.edge_src.device)
        mem_state = commit(mem_state, batch)
        if has:
            opt.step()
        return mem_state, (loss, torch.tensor(has))

    @torch.no_grad()
    def eval_core(mem_state, batch):
        has = has_node_labels(batch)
        if has:
            ndcg = ndcg_at_k(logits(mem_state, batch), batch.node_y, k,
                             row_valid=batch.node_y_valid)
        else:
            ndcg = torch.zeros((), device=batch.edge_src.device)
        return commit(mem_state, batch), (ndcg, torch.tensor(has))

    train_core.loss_and_grad = loss_and_grad
    train_core.commit = commit
    return train_core, eval_core


def build_tgat_node_cores(encoder: Any, decoder: Any, opt: Optional[torch.optim.Optimizer],
                          node_x: torch.Tensor,
                          k: int = DEFAULT_NDCG_K) -> Tuple[Callable, Callable]:
    """Return the TGAT node-property ``(train_core, eval_core)`` of
    ``examples/nodeproppred/tgat.py``.

    * ``train_core((generator,), batch) -> ((generator,), loss)``: the
      masked soft-label cross-entropy of the label nodes' logits, its
      backward and the optimizer step. The step runs on every batch, with
      labels or without, as the JAX example's does. The ``torch.Generator``
      draws the dropout masks (``None``: no dropout).
    * ``eval_core(carry, batch) -> (carry, ndcg)``: NDCG@k of the valid
      label rows (0 without labels); no dropout.

    Batches carry the node-label fields and the multi-hop recency hook's
    products seeded by ``node_y_nids``.
    ``train_core.loss_and_grad(batch, generator) -> loss`` is its first
    stage; ``opt.step()`` is the second.
    """

    def logits(batch, generator):
        return decoder(_tgat_embed(encoder, node_x, batch, generator))

    def loss_and_grad(batch, generator):
        if opt is None:
            raise ValueError("train_core needs an optimizer: build the cores with opt")
        return _label_loss_and_grad(opt, lambda: logits(batch, generator), batch)

    def train_core(carry, batch):
        (generator,) = carry
        loss = loss_and_grad(batch, generator)
        opt.step()
        return (generator,), loss

    @torch.no_grad()
    def eval_core(carry, batch):
        return carry, ndcg_at_k(logits(batch, None), batch.node_y, k,
                                row_valid=batch.node_y_valid)

    train_core.loss_and_grad = loss_and_grad
    return train_core, eval_core


def build_dygformer_node_cores(encoder: Any, decoder: Any, opt: Optional[torch.optim.Optimizer],
                               node_x: torch.Tensor,
                               k: int = DEFAULT_NDCG_K) -> Tuple[Callable, Callable]:
    """Return the DyGFormer node-property ``(train_core, eval_core)`` of
    ``examples/nodeproppred/dygformer.py``.

    Each label node is paired with itself: both transformer sides see its
    recency neighbours, and the head reads the source side's embedding.
    Rows count where ``node_y_valid & batch_nodes_mask`` (the label nodes
    already seen in edge events).

    * ``train_core((generator,), batch) -> ((generator,), loss)``: the
      masked soft-label cross-entropy, its backward and the optimizer step,
      on every batch (labels or not), as the JAX example's step. The
      ``torch.Generator`` draws the dropout masks (``None``: no dropout).
    * ``eval_core(carry, batch) -> (carry, ndcg)``: masked NDCG@k; no dropout.

    Batches carry the node-label fields, the one-hop recency hook's products
    seeded by ``node_y_nids`` (feature layout) and the seen-node hook's
    ``batch_nodes_mask``. ``train_core.loss_and_grad(batch, generator) ->
    loss`` is its first stage; ``opt.step()`` is the second.
    """

    def logits(batch, generator):
        nids, t = batch.node_y_nids, batch.node_y_time
        two = lambda x: torch.cat([x, x])
        zs, _ = encoder(node_x, nids, nids, t, two(batch.nbr_nids[0]),
                        two(batch.nbr_edge_time[0]), two(batch.nbr_edge_x[0]),
                        deterministic=generator is None, generator=generator)
        return decoder(zs)

    def row_mask(batch):
        return batch.node_y_valid & batch.batch_nodes_mask

    def loss_and_grad(batch, generator):
        if opt is None:
            raise ValueError("train_core needs an optimizer: build the cores with opt")
        zero_every_grad(opt)
        with torch.enable_grad():
            loss = soft_label_ce(logits(batch, generator), batch.node_y, row_mask(batch))
            loss.backward()
        return loss.detach()

    def train_core(carry, batch):
        (generator,) = carry
        loss = loss_and_grad(batch, generator)
        opt.step()
        return (generator,), loss

    @torch.no_grad()
    def eval_core(carry, batch):
        return carry, ndcg_at_k(logits(batch, None), batch.node_y, k, row_valid=row_mask(batch))

    train_core.loss_and_grad = loss_and_grad
    return train_core, eval_core


__all__ = [
    "bce_with_logits",
    "build_local_edges",
    "build_dygformer_eval_core",
    "build_dygformer_node_cores",
    "build_dygformer_train_core",
    "build_tgat_eval_core",
    "build_tgat_node_cores",
    "build_tgat_train_core",
    "build_tgn_hook_cores",
    "build_tgn_node_cores",
    "build_tpnet_link_cores",
    "build_tpnet_node_cores",
    "has_node_labels",
    "score_candidates",
    "score_seed_rows",
    "soft_label_ce",
    "tgn_embed",
    "tgn_eval_commit",
    "tgn_loss_and_grad",
    "tgn_train_commit",
    "tie_equal_candidates",
    "train_loss_and_grad",
    "zero_every_grad",
]
