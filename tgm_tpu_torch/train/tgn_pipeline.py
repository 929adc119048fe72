"""Fused TGN train and eval steps (port of ``tgm_tpu/train/tgn_pipeline.py``).

``TGNPipeline`` composes a whole TGN batch without the hook manager: random
negatives, the recency query, TGN memory staging, rowwise attention, BCE,
backward, the train-mode memory commit, the recency push and the optimizer
step in ``train_step(carry, batch) -> (carry, loss)``; candidate scoring
with the eval-mode commit in ``eval_step``. Epochs run through
``jit_scan_epoch`` (``train/epoch.py``). The steps share their stages with
the hook path's ``train_core`` / ``eval_core`` (``train/programs.py``), so
the two routes agree bit for bit on the same batches and negatives.

The carry keeps the JAX field names in torch idiom: ``params`` is an
``nn.ModuleDict`` of the memory (``"mem"``), encoder (``"enc"``) and
decoder (``"dec"``); ``opt_state`` the ``torch.optim.Adam`` over it;
``mem_state`` and ``rec_state`` the memory and recency state tensors;
``rng`` the ``torch.Generator`` the negatives are drawn from. A step
updates these objects in place and returns a carry holding the same ones.

Ported, fp32, in both recency layouts (``edge_x_full`` given: eid layout,
one launch of kernel K1 with the feature rows fused; ``None``: feature
layout, one launch of kernel K4 on the state in place): the rowwise path,
and ``rowwise=False``, the reference example's segment path for training
(the pipeline's own dedup of [src | dst | neg] and their neighbours, the segment
``GraphAttentionEmbedding``, a flush commit; ``eval_step`` is rowwise only,
as in JAX); ``packed_state=True`` on either (the memory state in the
packed layout, its store in PyTorch scatters); ``packed_recency=True`` in
the eid layout (the recency state packed into one (N+1, K, 3) buffer:
queries through K1's pre-gathered entry, pushes as one row write; ignored
in the feature layout, as in JAX). ``state_row_multiple`` (a TPU row
alignment) raises.

The bf16 options compute what the JAX ones do:
- ``feat_bf16`` stores ``edge_x_full`` in bf16 (K1 copies its bf16 rows);
  without ``attn_bf16`` the encoder promotes them to fp32.
- ``attn_bf16`` (``resolve_bf16``: ``"auto"`` and ``None`` are off) builds
  the rowwise encoder with ``kv_bf16`` and, rowwise, stores the table in
  bf16 too: the gathered rows feed only the bf16 K/V path, so
  ``bf16(gather(x)) == gather(bf16(x))`` bit for bit. ``eval_proj_table``
  is then the bf16 (E, embed) table, and ``eval_mem_bf16`` gives a bf16
  mirror of the memory for ``eval_step(mem_bf16=...)``: the S * K neighbour
  rows are gathered from it (they are cast to bf16 anyway), and after the
  commit the rows it touched are refreshed as their bf16 casts.
- ``dedup_staging`` stages each distinct row once (a sort, a cumsum and two
  scatters, padded to the row count with ``num_nodes``, no host sync) and
  gathers the staged rows back: the same staged values as without it.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..constants import PADDED_NODE_ID
from ..device import DeviceLike, resolve_device
from ..eval.metrics import mrr_sum_count
from ..hooks.dedup import map_to_local, sorted_unique
from ..hooks.neighbors import (
    recency_eid_init,
    recency_eid_update,
    recency_init,
    recency_pk_init,
    recency_pk_query,
    recency_pk_update,
    recency_update,
)
from ..nn.decoder.decoders import LinkPredictor
from ..nn.encoder.tgn import (
    GraphAttentionEmbedding,
    GraphAttentionEmbeddingRowwise,
    TGNMemory,
    rowwise_project_edge_feats,
    tgn_init_state,
    tgn_pack_state,
)
from ..nn.modules.bf16 import BF16
from ..ops.recency_select import (
    gather_edge_feats,
    recency_eid_select,
    recency_feats_select,
    seed_rows,
)
from ..util.precision import resolve_bf16
from ..weights import load_tgn_params
from .programs import (
    _batch_nodes,
    local_edges,
    score_candidates,
    tgn_embed,
    tgn_eval_commit,
    tgn_loss_and_grad,
    tgn_train_commit,
    tie_equal_candidates,
    train_loss_and_grad,
)

SCORE_LAYOUTS = ("lanesv", "lanes", "kmajor")


def default_feat_bf16() -> bool:
    """The JAX auto policy for bf16 feature tables: off (measured neutral on
    a TPU, so fp32 is the default everywhere)."""
    return False


class TGNCarry(NamedTuple):
    params: nn.ModuleDict
    opt_state: torch.optim.Optimizer
    mem_state: Any
    rec_state: Any
    rng: torch.Generator


def _unique_inverse(keyed: torch.Tensor, fill: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jnp.unique(keyed, size=len(keyed), fill_value=fill,
    return_inverse=True)`` with no host sync: the sorted distinct values,
    ``fill`` after them, and each entry's index into them."""
    s, order = torch.sort(keyed)
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    pos = torch.cumsum(first, 0) - 1  # each sorted entry's slot in the distinct list
    uniq = torch.full_like(keyed, fill).scatter_(0, pos, s)  # repeats write equal values
    return uniq, torch.empty_like(pos).scatter_(0, order, pos)


def dedup_stage(stage: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
                num_nodes: int) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """``stage(rows)`` run once over the distinct rows (ids outside [0, N)
    keyed to the dump row N, padded to the row count with N), its staged
    rows gathered back per entry: the same values as staging every row."""

    def staged(rows: torch.Tensor):
        keyed = torch.where((rows >= 0) & (rows < num_nodes), rows, num_nodes)
        uniq, inv = _unique_inverse(keyed, num_nodes)
        z_u, lu_u = stage(uniq)
        return z_u[inv], lu_u[inv]

    return staged


def _unported(option: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"TGNPipeline({option}) is not ported: {where}")


class TGNPipeline:
    """Build once per (graph, hyperparameters); the steps act on a carry.

    The constructor takes the JAX one's arguments plus ``device`` (default
    ``cuda``). ``attn_score_layout`` accepts the JAX values: they are one
    math in different TPU layouts, and the port computes one layout.
    ``dropout`` is kept on the encoder but, as in the JAX pipeline, no step
    draws it.
    """

    def __init__(
        self,
        num_nodes: int,
        edge_dim: int,
        memory_dim: int = 100,
        embed_dim: int = 100,
        time_dim: int = 100,
        num_nbrs: int = 10,
        lr: float = 1e-4,
        neg_low: int = 0,
        neg_high: int = 1,
        dropout: float = 0.0,
        state_row_multiple: int = 1,
        rowwise: bool = True,
        edge_x_full: Any = None,
        packed_state: bool = False,
        dedup_staging: bool = False,
        packed_recency: bool = False,
        feat_bf16: Optional[bool] = None,
        attn_bf16: Any = None,
        attn_score_layout: str = "lanesv",
        device: DeviceLike = None,
    ) -> None:
        if state_row_multiple != 1:
            raise _unported(f"state_row_multiple={state_row_multiple}",
                            "a TPU row-alignment device, not queued (ROADMAP.md)")
        if attn_score_layout not in SCORE_LAYOUTS:
            raise ValueError(f"attn_score_layout must be one of {SCORE_LAYOUTS}, "
                             f"got {attn_score_layout!r}")
        self.device = resolve_device(device)
        self.rowwise = rowwise
        self.packed_state = packed_state
        self.packed_recency = packed_recency
        self.num_nodes = num_nodes
        self.edge_dim = edge_dim
        self.memory_dim = memory_dim
        self.embed_dim = embed_dim
        self.time_dim = time_dim
        self.num_nbrs = num_nbrs
        self.lr = lr
        self.dropout = dropout
        self.neg_low = neg_low
        self.neg_high = max(neg_high, neg_low + 1)
        self.dedup_staging = dedup_staging
        self.feat_bf16 = default_feat_bf16() if feat_bf16 is None else bool(feat_bf16)
        # Resolved once: it drives both the encoder's kv_bf16 and the table.
        self.attn_bf16 = resolve_bf16(attn_bf16)
        table_dtype = (BF16 if self.feat_bf16 or (rowwise and self.attn_bf16)
                       else torch.float32)
        self.edge_x_full = (None if edge_x_full is None else
                            torch.as_tensor(edge_x_full, dtype=torch.float32,
                                            device=self.device).to(table_dtype).contiguous())

    # ------------------------------------------------------------------ #
    def init_carry(self, seed: int = 0, params: Optional[Any] = None) -> TGNCarry:
        """A fresh carry: weights initialised from ``seed`` (on the CPU, so
        every device starts from the same ones), or loaded from the JAX tree
        ``params`` (``{"mem", "enc", "dec"}``, ``weights.load_tgn_params``);
        Adam at ``lr`` built after them; zero memory (packed with
        ``packed_state``); empty recency buffers; the negatives' generator on
        the device, seeded with ``seed``."""
        enc_cls = GraphAttentionEmbeddingRowwise if self.rowwise else GraphAttentionEmbedding
        enc_kwargs = {"kv_bf16": self.attn_bf16} if self.rowwise else {}
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            modules = nn.ModuleDict({
                "mem": TGNMemory(self.num_nodes, self.edge_dim, self.memory_dim, self.time_dim),
                "enc": enc_cls(self.memory_dim, self.embed_dim, self.edge_dim, self.time_dim,
                               dropout=self.dropout, **enc_kwargs),
                "dec": LinkPredictor(node_dim=self.embed_dim, hidden_dim=self.embed_dim),
            })
        if params is not None:
            load_tgn_params(params, modules["mem"], modules["enc"], modules["dec"])
        modules.to(self.device)
        opt = torch.optim.Adam(modules.parameters(), lr=self.lr)
        mem_state = tgn_init_state(self.num_nodes, self.memory_dim, self.edge_dim, self.device)
        if self.packed_state:
            mem_state = tgn_pack_state(mem_state)
        if self.edge_x_full is not None and self.packed_recency:
            rec_state = recency_pk_init(self.num_nodes, self.num_nbrs, self.device)
        elif self.edge_x_full is not None:
            rec_state = recency_eid_init(self.num_nodes, self.num_nbrs, self.device)
        else:
            rec_state = recency_init(self.num_nodes, self.num_nbrs, self.edge_dim, self.device)
        rng = torch.Generator(device=self.device).manual_seed(seed)
        return TGNCarry(modules, opt, mem_state, rec_state, rng)

    def draw_neg(self, rng: torch.Generator, size: int) -> torch.Tensor:
        """``size`` int32 ids uniform in [neg_low, neg_high) from ``rng``, on
        its device. Tests replace this method to inject ids."""
        return torch.randint(self.neg_low, self.neg_high, (size,), generator=rng,
                             device=rng.device, dtype=torch.int32)

    # ------------------------------------------------------------------ #
    def _query(self, rec_state, seeds: torch.Tensor, seed_t: torch.Tensor,
               table: Optional[torch.Tensor] = None):
        """(S, K) neighbour ids and times and their (S, K, D) features: in the
        eid layout one launch of K1 with the rows of ``table`` (default
        ``edge_x_full``) fused; packed, K1's pre-gathered entry and a gather
        of ``table``'s rows; in the feature layout one launch of K4 that reads
        the buffers in place."""
        seeds, seed_t = seeds.int(), seed_t.int()
        if self.edge_x_full is not None:
            table = self.edge_x_full if table is None else table
            if self.packed_recency:
                nbrs, nbr_t, nbr_e = recency_pk_query(rec_state, seeds, seed_t, self.num_nbrs)
                return nbrs, nbr_t, gather_edge_feats(table, nbr_e)
            nbrs, nbr_t, _, nbr_x = recency_eid_select(rec_state, seeds, seed_t,
                                                       self.num_nbrs, table)
            return nbrs, nbr_t, nbr_x
        return recency_feats_select(rec_state, seeds, seed_t, self.num_nbrs)

    def _push(self, rec_state, batch):
        """The batch's undirected recency push (two launches; packed, one
        row write), in place."""
        if self.edge_x_full is not None:
            update = recency_pk_update if self.packed_recency else recency_eid_update
            return update(rec_state, batch.edge_src, batch.edge_dst,
                                      batch.edge_time, batch.edge_ids, batch.edge_valid,
                                      directed=False)
        return recency_update(rec_state, batch.edge_src, batch.edge_dst, batch.edge_time,
                              batch.edge_x if batch.has("edge_x") else None, batch.edge_valid,
                              directed=False)

    def _stage(self, memory: TGNMemory, mem_state, training: bool):
        """The ``stage`` of ``tgn_embed``: ``None`` (stage every row) or, with
        ``dedup_staging``, stage each distinct row of [seeds | neighbours]
        once (ids outside [0, N) keyed to the dump row N) and gather the
        staged rows back per entry."""
        if not self.dedup_staging:
            return None
        return dedup_stage(lambda rows: memory.stage(mem_state, rows, training=training),
                           self.num_nodes)

    def _train_seeds(self, batch, neg: torch.Tensor):
        seeds = torch.cat([batch.edge_src, batch.edge_dst, neg])
        return seeds, batch.edge_time.repeat(3)

    def _segment_embed(self, params, mem_state, seeds: torch.Tensor, nbrs: torch.Tensor,
                       nbr_t: torch.Tensor, nbr_x: torch.Tensor, stage=None) -> torch.Tensor:
        """Train-mode segment embeddings of ``seeds``' rows, in their order.

        The pipeline's own dedup, unlike the hook's: capacity U = all the
        S + S * K ids (no N + 1 cap), and the dense table is filled with U - 1,
        so a PAD or unseen id reads the last local row. Memory is staged over
        the unique ids, and the encoder runs over the (seed -> neighbour)
        edges. ``stage(ids)``, where given, replaces the train-mode
        ``memory.stage`` of ``mem_state`` (the node-sharded step stages rows
        fetched from their owners).
        """
        n = self.num_nodes
        all_ids = torch.cat([seeds, nbrs.reshape(-1)])
        U = all_ids.shape[0]
        uniq, u_valid = sorted_unique(all_ids, n, U)
        g2l = torch.full((n + 2,), U - 1, dtype=torch.int32, device=seeds.device)
        g2l[torch.where(u_valid, uniq, n + 1).long()] = torch.arange(
            U, dtype=torch.int32, device=seeds.device)
        g2l = g2l[: n + 1]
        if stage is None:
            stage = lambda ids: params["mem"].stage(mem_state, ids, training=True)
        z_mem, last_upd = stage(torch.where(u_valid, uniq, PADDED_NODE_ID))
        z = params["enc"](z_mem, last_upd, *local_edges(g2l, seeds, nbrs, nbr_t, nbr_x))
        return z[map_to_local(g2l, seeds).long()]

    # ------------------------------------------------------------------ #
    def train_step(self, carry: TGNCarry, batch) -> Tuple[TGNCarry, torch.Tensor]:
        """One train batch: negatives, the recency query, staged memory, the
        encoder, two decoder calls, masked BCE and backward; then the
        train-mode commit (rowwise: the staged src | dst rows; segment: a
        flush of them; then the message store), the recency push and the
        optimizer step. Returns the detached loss; nothing here waits for
        the card."""
        params, opt, mem_state, rec_state, rng = carry
        neg = self.draw_neg(rng, batch.edge_src.shape[0])
        # Padded rows must not inject live seeds into the batch.
        neg = torch.where(batch.edge_valid, neg, PADDED_NODE_ID)
        seeds, seed_t = self._train_seeds(batch, neg)
        nbrs, nbr_t, nbr_x = self._query(rec_state, seeds, seed_t)
        # No generator: the JAX pipeline's train step draws no dropout.
        if self.rowwise:
            loss, staged = tgn_loss_and_grad(params["mem"], params["enc"], params["dec"], opt,
                                             mem_state, seeds, nbrs, nbr_t, nbr_x,
                                             batch.edge_valid,
                                             stage=self._stage(params["mem"], mem_state, True))
        else:
            loss = train_loss_and_grad(
                opt, lambda: self._segment_embed(params, mem_state, seeds, nbrs, nbr_t, nbr_x),
                params["dec"], batch.edge_valid)
            staged = None
        # The reference order: the commit runs with the old parameters.
        mem_state = tgn_train_commit(params["mem"], mem_state, batch, self.num_nodes, staged)
        rec_state = self._push(rec_state, batch)
        opt.step()
        return TGNCarry(params, opt, mem_state, rec_state, rng), loss

    @torch.no_grad()
    def eval_step(
        self,
        carry: TGNCarry,
        batch,
        cands: torch.Tensor,  # (B, Q) candidate dst ids, PAD for none
        cand_times: Optional[torch.Tensor] = None,  # (B, Q); default edge_time
        nbr_proj_table: Optional[torch.Tensor] = None,  # (E, embed) from eval_proj_table
        mem_bf16: Optional[torch.Tensor] = None,  # (N+1, M) bf16 mirror from eval_mem_bf16
    ):
        """Score each edge against its candidates, then advance the state in
        the eval-mode order (store messages, then apply them; then the
        push). Returns ``(carry, (mrr_sum, mrr_count))``, and the refreshed
        mirror third when ``mem_bf16`` is given.

        Seeds are [src | dst | cands], S = 2B + BQ, on stored memory. With
        ``nbr_proj_table`` (eid layout) K1 copies its projected rows in place
        of the raw features and the encoder skips the message projection.
        With ``mem_bf16`` the neighbour rows come from the mirror (the seeds'
        from the fp32 memory), and the mirror's rows of this batch's nodes
        are rewritten, in place, as the bf16 casts of their committed rows.
        Positives and candidates are scored in one decoder call, and a
        candidate whose embedding equals the positive's ties with it.
        """
        if not self.rowwise:
            raise ValueError("eval_step requires the rowwise pipeline")
        if nbr_proj_table is not None and self.edge_x_full is None:
            raise ValueError("nbr_proj_table needs the eid layout (edge_x_full)")
        params, _, mem_state, rec_state, _ = carry
        B, Q = cands.shape
        if cand_times is None:
            cand_times = batch.edge_time[:, None].expand(B, Q)
        cand_flat = cands.reshape(-1).int()
        seeds = torch.cat([batch.edge_src, batch.edge_dst, cand_flat])
        seed_t = torch.cat([batch.edge_time, batch.edge_time, cand_times.reshape(-1).int()])
        nbrs, nbr_t, nbr_x = self._query(rec_state, seeds, seed_t, nbr_proj_table)
        proj = None if nbr_proj_table is None else nbr_x
        if mem_bf16 is None:
            z, _ = tgn_embed(params["mem"], params["enc"], mem_state, seeds, nbrs, nbr_t, nbr_x,
                             False, nbr_msg_proj=proj)
        else:
            self._check_mirror(mem_bf16)
            x_seed, last_upd = params["mem"].stage(mem_state, seeds, training=False)
            S, K = nbrs.shape
            z = params["enc"](x_seed, mem_bf16[seed_rows(nbrs.reshape(-1), self.num_nodes)]
                              .reshape(S, K, -1), last_upd, nbr_t, nbr_x,
                              nbrs != PADDED_NODE_ID, nbr_msg_proj=proj)
        z_dst, z_cand = z[B : 2 * B], z[2 * B :].reshape(B, Q, -1)
        pos, negs = score_candidates(params["dec"], z[:B], z_dst, z_cand)
        negs = tie_equal_candidates(pos, negs, z_dst, z_cand)
        s, c = mrr_sum_count(pos, negs, neg_valid=(cand_flat != PADDED_NODE_ID).reshape(B, Q),
                             edge_valid=batch.edge_valid)
        carry = self.eval_advance_state(carry, batch)
        if mem_bf16 is None:
            return carry, (s, c)
        touched = _batch_nodes(batch, self.num_nodes).long()
        mem_bf16[touched] = carry.mem_state.mem[touched].to(BF16)
        return carry, (s, c), mem_bf16

    def _check_mirror(self, mem_bf16: torch.Tensor) -> None:
        if not self.attn_bf16 or self.packed_state:
            raise ValueError("mem_bf16 needs attn_bf16 (the bf16 K/V path) and the unpacked "
                             "memory state")
        shape = (self.num_nodes + 1, self.memory_dim)
        if mem_bf16.dtype != BF16 or tuple(mem_bf16.shape) != shape:
            raise ValueError(f"mem_bf16 must be a bf16 {shape} tensor, got {mem_bf16.dtype} "
                             f"{tuple(mem_bf16.shape)}")

    def eval_mem_bf16(self, carry: TGNCarry) -> torch.Tensor:
        """The initial bf16 mirror of the (flushed) memory for an eval epoch
        (``eval_step``'s ``mem_bf16``); only with ``attn_bf16``, where the
        neighbour rows are cast to bf16 anyway."""
        mirror = carry.mem_state.mem.to(BF16)
        self._check_mirror(mirror)
        return mirror

    @torch.no_grad()
    def eval_advance_state(self, carry: TGNCarry, batch) -> TGNCarry:
        """Advance only the state (the eval-mode commit, then the push),
        exactly as ``eval_step`` does, without scoring."""
        params, opt, mem_state, rec_state, rng = carry
        mem_state = tgn_eval_commit(params["mem"], mem_state, batch, self.num_nodes)
        rec_state = self._push(rec_state, batch)
        return TGNCarry(params, opt, mem_state, rec_state, rng)

    def eval_proj_table(self, params: nn.ModuleDict) -> torch.Tensor:
        """``edge_x_full @ W_m^T`` for frozen weights: pass it to ``eval_step``
        as ``nbr_proj_table`` for a whole eval epoch (one (E, msg) x (msg,
        embed) product; in bf16 under ``attn_bf16``, as in JAX)."""
        if self.edge_x_full is None or not self.rowwise:
            raise ValueError("eval_proj_table needs the rowwise pipeline in the eid layout "
                             "(edge_x_full)")
        return rowwise_project_edge_feats(params["enc"], self.edge_x_full, self.attn_bf16)

    def flush_all(self, carry: TGNCarry) -> TGNCarry:
        """Train -> eval transition: apply every pending message, clear the stores."""
        return carry._replace(mem_state=carry.params["mem"].flush_all(carry.mem_state))

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def forward_only(self, carry: TGNCarry, batch) -> torch.Tensor:
        """(2, B) scores of (src, dst) and (src, flip(dst)) on staged memory
        (train mode), leaving the state as it was."""
        params, _, mem_state, rec_state, _ = carry
        B = batch.edge_src.shape[0]
        seeds, seed_t = self._train_seeds(batch, torch.flip(batch.edge_dst, (0,)))
        nbrs, nbr_t, nbr_x = self._query(rec_state, seeds, seed_t)
        if self.rowwise:
            z, _ = tgn_embed(params["mem"], params["enc"], mem_state, seeds, nbrs, nbr_t, nbr_x,
                             True, stage=self._stage(params["mem"], mem_state, True))
        else:
            z = self._segment_embed(params, mem_state, seeds, nbrs, nbr_t, nbr_x)
        dec = params["dec"]
        return torch.stack([dec(z[:B], z[B : 2 * B]), dec(z[:B], z[2 * B :])])


__all__ = ["TGNCarry", "TGNPipeline", "default_feat_bf16"]
