"""Fused TGAT train and eval steps (port of ``tgm_tpu/train/tgat_pipeline.py``).

``TGATPipeline`` composes a whole TGAT batch without the hook manager:
random negatives, the multi-hop recency expansion, the TGAT encoder, BCE,
backward, the recency push and the optimizer step in ``train_step(carry,
batch) -> (carry, loss)``; candidate scoring and the push in ``eval_step``.
Epochs run through ``jit_scan_epoch`` (``train/epoch.py``).

The carry keeps the JAX field names in torch idiom: ``params`` is an
``nn.ModuleDict`` of the encoder (``"enc"``) and decoder (``"dec"``);
``opt_state`` the ``torch.optim.Adam`` over it; ``rec_state`` the recency
state tensors; ``rng`` the ``torch.Generator`` the negatives are drawn
from. A step updates these objects in place and returns a carry holding
the same ones.

With ``edge_x_full`` and ``edge_ends_full`` the rings carry side-augmented
payloads ``2 * eid + side`` (side: which endpoint is the stored neighbour)
and the deepest hop's [neighbour node ‖ edge] K/V rows come from the
side-augmented table (``build_aug_table``) in the same launch of kernel K1
that selects them; the shallower hops select with K1 and gather their edge
rows by ``payload >> 1``. With ``edge_x_full`` alone the rings carry edge
ids (one K1 launch a hop, the feature rows fused); with neither, edge
features by value (K4, the state read in place). Every layout pushes once a step (the push kernel).

The bf16 options compute what the JAX ones do (``None`` resolves to off,
as the JAX auto policies do on any backend but a TPU):
- ``feat_bf16`` rounds ``node_x`` and ``edge_x_full`` to bf16 before the
  side-augmented table is built; the fp32 attention promotes them.
- ``attn_bf16`` builds ``TGAT(kv_bf16=True)`` and stores ``edge_x_full``
  and the side-augmented table in bf16 (every reader of them is on the bf16
  K/V path); K1 copies their bf16 rows.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from ..constants import PADDED_NODE_ID
from ..device import DeviceLike, resolve_device
from ..eval.metrics import mrr_sum_count
from ..hooks.neighbors import (
    recency_eid_init,
    recency_eid_update,
    recency_init,
    recency_update,
)
from ..nn.decoder.decoders import LinkPredictor
from ..nn.encoder.tgat import TGAT
from ..nn.modules.attention import SCORE_LAYOUTS
from ..nn.modules.bf16 import BF16
from ..ops.recency_select import gather_edge_feats, recency_eid_select, recency_feats_select
from ..util.precision import tpu_default_bf16
from ..weights import load_tgat_params
from .programs import score_candidates, tie_equal_candidates, train_loss_and_grad
from .tgn_pipeline import default_feat_bf16


class TGATCarry(NamedTuple):
    params: nn.ModuleDict
    opt_state: torch.optim.Optimizer
    rec_state: Any
    rng: torch.Generator


def build_aug_table(
    edge_x: torch.Tensor,  # (E, D) static edge features
    node_x: torch.Tensor,  # (N, d) static node features
    edge_src: Any,  # (E,) endpoints aligned with edge_x rows
    edge_dst: Any,
) -> torch.Tensor:
    """Side-augmented feature table (2E, d + D): row ``2e + side`` is
    [node_x[v] ‖ edge_x[e]], ``v`` edge e's src (side 0) or dst (side 1).

    The recency rings then carry ``2 * eid + side`` and one row serves a
    slot's neighbour node features and edge features, in the order of
    ``TemporalAttention``'s K/V input. Endpoint arrays shorter than the
    table (a table padded past the real edge count) are padded with node 0;
    those rows are never read through a valid payload."""
    E = edge_x.shape[0]
    dev = edge_x.device

    def fit(v):
        v = torch.as_tensor(v, device=dev).long()[:E]
        return torch.cat([v, v.new_zeros(E - v.shape[0])])

    a = torch.cat([node_x[fit(edge_src)], edge_x], dim=1)
    b = torch.cat([node_x[fit(edge_dst)], edge_x], dim=1)
    return torch.stack([a, b], dim=1).reshape(2 * E, -1).contiguous()


def default_attn_bf16() -> bool:
    """The JAX auto policy for the bf16 K/V attention: on for TPU backends
    only (``util.precision``), so off here."""
    return tpu_default_bf16()


class TGATPipeline:
    """Build once per (graph, hyperparameters); the steps act on a carry.

    The constructor takes the JAX one's arguments plus ``device`` (default
    ``cuda``). ``state_row_multiple`` (a TPU row alignment) is accepted and
    has no effect; ``attn_score_layout`` takes the JAX values, one function
    in different TPU layouts. The encoder has no dropout, as in the JAX
    pipeline.
    """

    def __init__(
        self,
        num_nodes: int,
        edge_dim: int,
        node_x: Any,
        num_nbrs: Sequence[int] = (10, 10),
        time_dim: int = 100,
        embed_dim: int = 100,
        n_heads: int = 2,
        lr: float = 1e-4,
        neg_low: int = 0,
        neg_high: int = 1,
        state_row_multiple: int = 1,
        edge_x_full: Any = None,
        edge_ends_full: Any = None,
        feat_bf16: Optional[bool] = None,
        attn_bf16: Optional[bool] = None,
        attn_score_layout: str = "kmajor",
        device: DeviceLike = None,
    ) -> None:
        if attn_score_layout not in SCORE_LAYOUTS:
            raise ValueError(f"attn_score_layout must be one of {SCORE_LAYOUTS}, "
                             f"got {attn_score_layout!r}")
        self.device = resolve_device(device)
        self.feat_bf16 = default_feat_bf16() if feat_bf16 is None else bool(feat_bf16)
        self.attn_bf16 = default_attn_bf16() if attn_bf16 is None else bool(attn_bf16)
        feat_dt = BF16 if self.feat_bf16 else torch.float32
        table = lambda x: (torch.as_tensor(x, dtype=torch.float32, device=self.device)
                           .to(feat_dt).contiguous())
        self.num_nodes = num_nodes
        self.edge_dim = edge_dim
        self.node_x = table(node_x)
        self.num_nbrs = list(num_nbrs)
        self.time_dim = time_dim
        self.embed_dim = embed_dim
        self.n_heads = n_heads
        self.lr = lr
        self.neg_low = neg_low
        self.neg_high = max(neg_high, neg_low + 1)
        self.attn_score_layout = attn_score_layout
        self.edge_x_full = None if edge_x_full is None else table(edge_x_full)
        self.aug_x = None
        if self.edge_x_full is not None and edge_ends_full is not None:
            self.aug_x = build_aug_table(self.edge_x_full, self.node_x, *edge_ends_full)
        if self.attn_bf16:
            # Every reader of the static edge tables is on the bf16 K/V path.
            if self.edge_x_full is not None:
                self.edge_x_full = self.edge_x_full.to(BF16)
            if self.aug_x is not None:
                self.aug_x = self.aug_x.to(BF16)
        if self.aug_x is not None:
            # The fill of an invalid deepest-hop slot: the PAD-wrapped node row
            # and zero edge features, what the unfused K/V input holds there.
            self.aug_fill = torch.cat([self.node_x[-1], self.node_x.new_zeros(edge_dim)]
                                      ).to(self.aug_x.dtype)

    # ------------------------------------------------------------------ #
    def init_carry(self, seed: int = 0, params: Optional[Any] = None) -> TGATCarry:
        """A fresh carry: weights initialised from ``seed`` (on the CPU, so
        every device starts from the same ones), or loaded from the JAX tree
        ``params`` (``{"enc", "dec"}``, ``weights.load_tgat_params``); Adam
        at ``lr`` built after them; empty recency buffers; the negatives'
        generator on the device, seeded with ``seed``."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            modules = nn.ModuleDict({
                "enc": TGAT(self.node_x.shape[1], self.edge_dim, self.time_dim, self.embed_dim,
                            len(self.num_nbrs), self.n_heads, dropout=0.0,
                            kv_bf16=self.attn_bf16, score_layout=self.attn_score_layout),
                "dec": LinkPredictor(node_dim=self.embed_dim, hidden_dim=self.embed_dim),
            })
        if params is not None:
            load_tgat_params(params, modules["enc"], modules["dec"])
        modules.to(self.device)
        opt = torch.optim.Adam(modules.parameters(), lr=self.lr)
        B = max(self.num_nbrs)
        if self.edge_x_full is not None:
            rec_state = recency_eid_init(self.num_nodes, B, self.device)
        else:
            rec_state = recency_init(self.num_nodes, B, self.edge_dim, self.device)
        rng = torch.Generator(device=self.device).manual_seed(seed)
        return TGATCarry(modules, opt, rec_state, rng)

    def draw_neg(self, rng: torch.Generator, size: int) -> torch.Tensor:
        """``size`` int32 ids uniform in [neg_low, neg_high) from ``rng``, on
        its device. Tests replace this method to inject ids."""
        return torch.randint(self.neg_low, self.neg_high, (size,), generator=rng,
                             device=rng.device, dtype=torch.int32)

    # ------------------------------------------------------------------ #
    def _hops(self, rec_state, seeds: torch.Tensor, seed_t: torch.Tensor, select=None):
        """Multi-hop recency expansion (hop i+1's seeds are hop i's neighbours).

        Returns ``(hops, nbr_kv_x)``: ``hops`` is TGAT's argument tuple
        (seed_nids, seed_times, nbr_nids, nbr_edge_x, nbr_edge_time), per hop;
        ``nbr_kv_x`` the per-hop [node ‖ edge] K/V rows with the aug table
        (the deepest hop's only; ``None`` otherwise). One K1 (or K4) launch
        a hop. ``select`` (default ``_select_hop``) answers one hop; the
        node-sharded step gives one that asks each seed's owner."""
        select = self._select_hop if select is None else select
        hop_seeds, hop_times = [seeds.int()], [seed_t.int()]
        hop_nbrs: List[torch.Tensor] = []
        hop_nbr_t: List[torch.Tensor] = []
        hop_nbr_x: List[torch.Tensor] = []
        hop_kv = None if self.aug_x is None else [None] * len(self.num_nbrs)
        for hop in range(len(self.num_nbrs)):
            if hop > 0:
                hop_seeds.append(hop_nbrs[-1].reshape(-1))
                hop_times.append(hop_nbr_t[-1].reshape(-1))
            nbrs, nts, nxs, kv = select(rec_state, hop, hop_seeds[-1], hop_times[-1])
            if hop_kv is not None:
                hop_kv[hop] = kv
            hop_nbrs.append(nbrs)
            hop_nbr_t.append(nts)
            hop_nbr_x.append(nxs)
        return (hop_seeds, hop_times, hop_nbrs, hop_nbr_x, hop_nbr_t), hop_kv

    def _select_hop(self, rec_state, hop: int, seeds: torch.Tensor, seed_t: torch.Tensor):
        """One hop's ``(nbrs, times, edge features, K/V rows or None)`` of
        (S,) int32 seeds at their times: one K1 (or K4) launch."""
        k = self.num_nbrs[hop]
        if self.aug_x is not None and hop == len(self.num_nbrs) - 1:
            nbrs, nts, pay, kv = recency_eid_select(rec_state, seeds, seed_t, k, self.aug_x)
            kv = torch.where((pay >= 0)[..., None], kv, self.aug_fill)
            # Never read: the deepest hop's edge features live in its K/V rows.
            return nbrs, nts, kv.new_zeros(()).expand(nbrs.shape + (self.edge_dim,)), kv
        if self.aug_x is not None:
            nbrs, nts, pay, _ = recency_eid_select(rec_state, seeds, seed_t, k)
            return (nbrs, nts,
                    gather_edge_feats(self.edge_x_full, torch.where(pay >= 0, pay >> 1, -1)), None)
        if self.edge_x_full is not None:
            nbrs, nts, _, nxs = recency_eid_select(rec_state, seeds, seed_t, k, self.edge_x_full)
            return nbrs, nts, nxs, None
        return (*recency_feats_select(rec_state, seeds, seed_t, k), None)

    def _push(self, rec_state, batch):
        """Advance the recency buffers with this batch's events (one push, in place)."""
        if self.aug_x is not None:
            # Both orientations as one directed push with side-augmented
            # payloads (2 * eid + side, side = the endpoint stored as the
            # neighbour): the write plan of the undirected push of (src, dst).
            two = lambda a, b: torch.cat([a, b])
            ids = batch.edge_ids
            return recency_eid_update(
                rec_state, two(batch.edge_src, batch.edge_dst), two(batch.edge_dst, batch.edge_src),
                two(batch.edge_time, batch.edge_time), two(ids * 2 + 1, ids * 2),
                None if batch.edge_valid is None else two(batch.edge_valid, batch.edge_valid),
                directed=True,
            )
        if self.edge_x_full is not None:
            return recency_eid_update(rec_state, batch.edge_src, batch.edge_dst, batch.edge_time,
                                      batch.edge_ids, batch.edge_valid, directed=False)
        return recency_update(rec_state, batch.edge_src, batch.edge_dst, batch.edge_time,
                              batch.edge_x if batch.has("edge_x") else None, batch.edge_valid,
                              directed=False)

    def _embed(self, params: nn.ModuleDict, hops, kv) -> torch.Tensor:
        return params["enc"](self.node_x, *hops, nbr_kv_x=kv)

    # ------------------------------------------------------------------ #
    def train_step(self, carry: TGATCarry, batch) -> Tuple[TGATCarry, torch.Tensor]:
        """One train batch: negatives, the hops, TGAT, two decoder calls,
        masked BCE and backward; then the recency push and the optimizer
        step. Returns the detached loss; nothing here waits for the card."""
        params, opt, rec_state, rng = carry
        neg = self.draw_neg(rng, batch.edge_src.shape[0])
        neg = torch.where(batch.edge_valid, neg, PADDED_NODE_ID)
        seeds = torch.cat([batch.edge_src, batch.edge_dst, neg])
        hops, kv = self._hops(rec_state, seeds, batch.edge_time.repeat(3))
        loss = train_loss_and_grad(opt, lambda: self._embed(params, hops, kv), params["dec"],
                                   batch.edge_valid)
        rec_state = self._push(rec_state, batch)
        opt.step()
        return TGATCarry(params, opt, rec_state, rng), loss

    @torch.no_grad()
    def eval_step(
        self,
        carry: TGATCarry,
        batch,
        cands: torch.Tensor,  # (B, Q) candidate dst ids, PAD for none
        cand_times: Optional[torch.Tensor] = None,  # (B, Q); default edge_time
    ) -> Tuple[TGATCarry, Tuple[torch.Tensor, torch.Tensor]]:
        """Score each edge against its (B, Q) candidates, then push the batch.
        Returns ``(carry, (mrr_sum, mrr_count))``.

        Seeds are [src | dst | cands flattened], S = 2B + BQ (the flat
        candidate list, not the unique set). Positives and candidates are
        scored in one decoder call, and a candidate whose embedding equals
        the positive's ties with it.
        """
        B, Q = cands.shape
        if cand_times is None:
            cand_times = batch.edge_time[:, None].expand(B, Q)
        cand_flat = cands.reshape(-1).int()
        seeds = torch.cat([batch.edge_src, batch.edge_dst, cand_flat])
        seed_t = torch.cat([batch.edge_time, batch.edge_time, cand_times.reshape(-1).int()])
        z = self.embed(carry, seeds, seed_t)
        z_dst, z_cand = z[B : 2 * B], z[2 * B :].reshape(B, Q, -1)
        pos, negs = score_candidates(carry.params["dec"], z[:B], z_dst, z_cand)
        negs = tie_equal_candidates(pos, negs, z_dst, z_cand)
        s, c = mrr_sum_count(pos, negs, neg_valid=(cand_flat != PADDED_NODE_ID).reshape(B, Q),
                             edge_valid=batch.edge_valid)
        params, opt, rec_state, rng = carry
        rec_state = self._push(rec_state, batch)
        return TGATCarry(params, opt, rec_state, rng), (s, c)

    @torch.no_grad()
    def embed(self, carry: TGATCarry, seeds: torch.Tensor, seed_times: torch.Tensor
              ) -> torch.Tensor:
        """(S, embed_dim) TGAT embeddings of ``seeds`` at ``seed_times`` on the
        carry's recency state, which is left as it was."""
        return self._embed(carry.params, *self._hops(carry.rec_state, seeds, seed_times))


__all__ = ["TGATCarry", "TGATPipeline", "build_aug_table", "default_attn_bf16"]
