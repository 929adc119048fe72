"""Two A/B timings on the card for the port's TNCN example.

1. The eval seeds' adjacency rows: ``ncn_adjacency_rows`` (any seed list:
   the seed rows consolidated over each node, the neighbour side one
   column gather; the port's one builder) against the JAX package's
   blocked form for lists whose tail is distinct (head rows consolidated
   over the head, each row plus its node's tail row, the neighbour side in
   two parts), written with the port's ops and copied here. Timed alone on
   eval-shaped seed lists over U = 9,228 local ids (tgbl-wiki's N + 1: S =
   2B + 4,000 distinct candidates = 4,400 seeds, K = 10 neighbours, uniform
   ids, a tenth of the slots PAD), alone on the stream's own val seed lists
   (its static U, which the zipf stream's few distinct ids leave mostly
   empty), and over TNCN eval batches (``eval_core``).
2. The train step's scoring: the table path (the memory staged over the
   batch's unique nodes, the segment encoder, the adjacency rows; the
   port's ``train_core``) against the JAX package's occurrence-space
   scoring (every quantity on the occurrence list of raw ids, per-node sums
   as segment sums), copied here, in the same step (forward, backward,
   commit, Adam) over TNCN train batches, at k = 2 and k = 4, no dropout.

    python3 scripts/torch_tncn_ab.py [--reps 40] [--device cuda] [--dataset NAME]

The example runs at its defaults on ``chip_smoke.py``'s stream (or on
``--dataset``), TF32 off; the train split first runs through the hooks
alone so that val's recency rows are real. Timing, alternation and the
printed lines are ``torch_mixer_ab.py``'s: each variant's median, minimum
and maximum ms, its peak allocation over the call's start, the largest gap
of its output from the first variant's, and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import copy
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402  (its stream and the examples' default flags)
from torch_mixer_ab import ab, hook_batches  # noqa: E402
from tgm_tpu_torch.examples import _linkpred_common as lp  # noqa: E402
from tgm_tpu_torch.examples.linkproppred import tncn  # noqa: E402
from tgm_tpu_torch.hooks.dedup import map_to_local  # noqa: E402
from tgm_tpu_torch.nn.decoder.ncnpred import _part1, _slot, _valid  # noqa: E402
from tgm_tpu_torch.nn.decoder.ncnpred import ncn_adjacency_rows  # noqa: E402
from tgm_tpu_torch.ops.segment import segment_sum  # noqa: E402
from tgm_tpu_torch.train.programs import bce_with_logits, zero_every_grad  # noqa: E402


# ---------------------------------------------------------------------- #
# 1. The adjacency builders
# ---------------------------------------------------------------------- #
def _representatives(ids, n, base, absent):
    """(n + 1,) table: the last position (offset by ``base``) of each id of
    ``ids`` in [0, n), ``absent`` elsewhere and at slot n."""
    pos = torch.arange(ids.shape[0], device=ids.device) + base
    lut = torch.full((n + 1,), absent, dtype=torch.long, device=ids.device)
    lut.scatter_reduce_(0, _slot(ids, n), pos, reduce="amax", include_self=False)
    lut[n] = absent
    return lut


def blocked_rows(seeds_local, nbrs_local, nbr_valid, num_local, unique_from):
    """``ncn_adjacency_rows`` in the JAX function's blocks, for seed lists
    whose rows from ``unique_from`` on are distinct: the head rows [0, F)
    consolidated over the head, each row plus the part1 row of its node's
    tail position; the neighbour side's head columns through the head
    seeds, each tail seed's column from its tail position. Bit-equal."""
    S = seeds_local.shape[0]
    U, F = num_local, unique_from
    part1 = _part1(nbrs_local, nbr_valid, U)  # row S: zeros
    seed_slot = _slot(seeds_local, U)
    head_slot = seed_slot[:F]
    head_lut = _representatives(seeds_local[:F], U, 0, F)
    head = torch.zeros(F + 2, U + 1, device=part1.device).index_add_(
        0, torch.where(head_slot < U, head_lut[head_slot], F + 1), part1[:F])
    rows = head[head_lut[seed_slot]]
    tail_pos = _representatives(seeds_local[F:], U, F, S)
    rows += part1[tail_pos[seed_slot]]
    rows.index_add_(1, head_slot, part1[:F, seed_slot].T)
    rows = rows[:, :U]
    rows += part1[:, seed_slot][tail_pos[:U]].T
    return torch.where(_valid(seeds_local, U)[:, None], rows, 0.0)


def plain_rows(seeds, nbrs, ok, num_local, unique_from):
    return ncn_adjacency_rows(seeds, nbrs, ok, num_local)


BUILDERS = {"plain": plain_rows, "blocked": blocked_rows}
cur = ["plain"]
eval_from = [0]  # the eval batches' 2B


def set_builder(name):
    """The builder the alone timing calls and the example's."""
    cur[0] = name
    tncn.ncn_adjacency_rows = (ncn_adjacency_rows if name == "plain" else
                               lambda s, n, v, u: blocked_rows(s, n, v, u, eval_from[0]))


def seed_lists(batches):
    """Each eval batch's builder inputs: local seeds, local neighbours, the
    valid-slot mask, U (the dedup table's static rows, as the example
    passes it) and the distinct tail's start 2B."""
    out = []
    for b in batches:
        g2l = b.global_to_local
        ok = (b.nbr_nids[0] != -1) & (b.seed_nids[0][:, None] != -1)
        out.append((map_to_local(g2l, b.seed_nids[0]), map_to_local(g2l, b.nbr_nids[0]), ok,
                    b.unique_nids.shape[0], 2 * b.edge_src.shape[0]))
    return out


def wide_lists(n, dev, seed, U=9228, B=200, Q=20, K=10):
    """``n`` eval-shaped builder inputs over ``U`` local ids: src and dst
    uniform, then B * Q distinct candidates, K uniform neighbour slots a
    seed with a tenth PAD."""
    g = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for _ in range(n):
        head = torch.randint(0, U - 1, (2 * B,), generator=g, device=dev)
        tail = torch.randperm(U - 1, generator=g, device=dev)[: B * Q]
        seeds = torch.cat([head, tail]).int()
        nbrs = torch.randint(0, U - 1, (seeds.shape[0], K), generator=g, device=dev).int()
        pad = torch.rand(nbrs.shape, generator=g, device=dev) < 0.1
        nbrs = torch.where(pad, -1, nbrs)
        out.append((seeds, nbrs, nbrs >= 0, U, 2 * B))
    return out


# ---------------------------------------------------------------------- #
# 2. The occurrence-space train scores
# ---------------------------------------------------------------------- #
def _valid_ids(ids, n):
    return (ids >= 0) & (ids < n)


def _at(table, ids, n):
    """``table[ids]``, zero rows at ids outside [0, n)."""
    ok = _valid_ids(ids, n)
    rows = table[ids.long().clamp(0, n - 1)]
    return rows * ok.reshape(ok.shape + (1,) * (rows.dim() - 1)).to(rows.dtype)


def _first_occurrence(ids, n):
    idx = torch.arange(ids.shape[0], device=ids.device)
    slot = torch.where(_valid_ids(ids, n), ids.long(), n)
    first = torch.full((n + 1,), ids.shape[0], dtype=idx.dtype, device=ids.device)
    first.scatter_reduce_(0, slot, idx, reduce="amin")
    return (idx == first[slot]) & _valid_ids(ids, n)


def occurrence_scores(memory, encoder, decoder, mem_state, seeds, nbrs, nbr_time, nbr_msg,
                      nbr_ok, B):
    """The (B,) positive and negative train scores on the occurrence list
    ``[seeds (S) ‖ neighbour slots (S * K)]`` (k in {2, 4}, no decay): the
    memory staged at every occurrence, the softmax denominators and the
    seeds' attention rows per-node segment sums over raw ids, ``cn @ z`` as
    a first-occurrence skip part plus the neighbour slots' weighted values,
    the adjacency rows read at occurrence columns."""
    S, K = nbrs.shape
    E, N = S * K, memory.num_nodes
    nbr_flat, e_valid = nbrs.reshape(E), nbr_ok.reshape(E)
    occ = torch.cat([seeds, nbr_flat])
    staged, last = memory.stage(mem_state, occ, training=True)
    x_seed, x_nbr = staged[:S], staged[S:]
    H, C = encoder.n_heads, encoder.head_dim
    rel_t = last[:S].repeat_interleave(K) - nbr_time.reshape(E)
    e = encoder.edge_projection(encoder.time_enc(rel_t.float()),
                                nbr_msg.reshape(E, -1)).reshape(E, H, C)
    k_e = encoder.lin_key(x_seed).reshape(S, H, C).repeat_interleave(K, dim=0) + e
    v_e = encoder.lin_value(x_seed).reshape(S, H, C).repeat_interleave(K, dim=0) + e
    q_e = encoder.lin_query(x_nbr).reshape(E, H, C)
    logits = torch.where(e_valid[:, None], (q_e * k_e).sum(-1) * (C ** -0.5), -1e30)
    m = logits.amax(0)
    p = torch.where(e_valid[:, None], torch.exp(logits - m.clamp_min(-1e30)[None, :]), 0.0)
    alpha = p / _at(segment_sum(p, nbr_flat, N, mask=e_valid), nbr_flat, N).clamp_min(1e-16)
    av = (alpha[:, :, None] * v_e).reshape(E, H * C)
    z_seed = encoder.lin_skip(x_seed) + _at(segment_sum(av, nbr_flat, N, mask=e_valid), seeds,
                                            N)
    w = nbr_ok & _valid_ids(seeds, N)[:, None]
    rows = ncn_adjacency_rows(seeds, nbrs, w, N)[:, occ.long().clamp(0, N - 1)]
    rows = torch.where(_valid_ids(occ, N)[None, :], rows, 0.0)
    first = _first_occurrence(occ, N).float()[None, :]
    y_occ = encoder.lin_skip(staged)

    def cn_emb(cn):
        return (cn * first) @ y_occ + cn[:, S:] @ av

    ri, rj_pos, rj_neg = rows[:B], rows[B : 2 * B], rows[2 * B : 3 * B]
    if decoder.k == 2:
        embs_pos, embs_neg = [cn_emb(ri * rj_pos)], [cn_emb(ri * rj_neg)]
    else:
        def onehot(tar):
            return ((occ[None, :] == tar[:, None]) & _valid_ids(tar, N)[:, None]).float()

        r0_i, r0_pos, r0_neg = onehot(seeds[:B]), onehot(seeds[B : 2 * B]), onehot(seeds[2 * B :])
        embs_pos = [cn_emb(r0_i * rj_pos), cn_emb(ri * r0_pos), cn_emb(ri * rj_pos)]
        embs_neg = [cn_emb(r0_i * rj_neg), cn_emb(ri * r0_neg), cn_emb(ri * rj_neg)]
    zi = z_seed[:B]

    def score(zj, embs):
        return decoder.xsmlp(torch.cat([zi * zj] + embs, dim=-1)).reshape(-1)

    return score(z_seed[B : 2 * B], embs_pos), score(z_seed[2 * B :], embs_neg)


def occurrence_core(ctx):
    """``ctx.train_core`` with the occurrence scores in place of the table
    path's: loss and backward, the commit, the optimizer step."""

    def loss_and_grad(mem, batch, generator=None):
        zero_every_grad(ctx.opt)
        with torch.enable_grad():
            ok = (batch.nbr_nids[0] != -1) & (batch.seed_nids[0][:, None] != -1)
            pos, neg = occurrence_scores(ctx.memory, ctx.encoder, ctx.decoder, mem,
                                         batch.seed_nids[0], batch.nbr_nids[0],
                                         batch.nbr_edge_time[0], batch.nbr_edge_x[0], ok,
                                         batch.edge_src.shape[0])
            loss = (bce_with_logits(pos, torch.ones_like(pos), batch.edge_valid)
                    + bce_with_logits(neg, torch.zeros_like(neg), batch.edge_valid))
            loss.backward()
        return loss.detach()

    def core(carry, batch):
        mem, generator = carry
        loss = loss_and_grad(mem, batch)
        mem = ctx.train_core.commit(mem, batch)
        ctx.opt.step()
        return (mem, generator), loss

    core.loss_and_grad = loss_and_grad
    return core


def build(seed, dev, data, cands, argv=()):
    args = smoke._example_args(tncn, seed, dev, argv, dropout=0.0)
    if data is None:
        args.dataset = cands
        return tncn.build(args)
    return tncn.build(args, data=copy.copy(data), cands=(cands["val"], cands["test"]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dataset", default=None,
                    help="an example dataset (synthetic-N-E) in place of the smoke's stream")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("torch_tncn_ab.py: no card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smoke.nvidia_smi() if dev.type == "cuda" else "cpu"
    print(card, flush=True)
    if args.dataset is None:
        data, _, _, _, cands = smoke.build_stream(args.seed)
    else:
        data, cands = None, args.dataset
    nb = min(args.reps, 20)

    # 1. The eval seeds' adjacency rows.
    ctx = build(args.seed, dev, data, cands)
    train = hook_batches(ctx, "train", 50, nb)
    ctx.hm.reset_state()
    lp.run_split(ctx.setup, "train", lambda batch: torch.zeros(()))
    val = hook_batches(ctx, "val", 0, nb)
    eval_from[0] = 2 * val[0].edge_src.shape[0]
    names = list(BUILDERS)
    for label, lists in (("rows-wide", wide_lists(nb, dev, args.seed)),
                         ("rows-stream", seed_lists(val))):
        print(f"[{label}] S {lists[0][0].shape[0]}, U {lists[0][3]}, distinct seeds "
              f"{lists[0][0].unique().numel()}", flush=True)
        ab(label, names, set_builder, lists, lambda x: BUILDERS[cur[0]](*x),
           lambda: BUILDERS[cur[0]](*lists[0]), args.reps, dev, card)
    ab("tncn-eval", names, set_builder, val, lambda b: ctx.eval_core(ctx.mem, b),
       lambda: torch.stack(ctx.eval_core(ctx.mem.__class__(*(x.clone() for x in ctx.mem)),
                                         val[0])[1]), args.reps, dev, card)
    set_builder("plain")

    # 2. The train step's scoring, table against occurrence.
    for k in ("2", "4"):
        if k != "2":
            ctx = build(args.seed, dev, data, cands, ["--ncn-k", k])
            train = hook_batches(ctx, "train", 50, nb)
        cores = {"table": ctx.train_core, "occurrence": occurrence_core(ctx)}
        mode = ["table"]
        ab(f"tncn-train-k{k}", list(cores), lambda name: mode.__setitem__(0, name), train,
           lambda b: cores[mode[0]]((ctx.mem, None), b),
           lambda: cores[mode[0]].loss_and_grad(ctx.mem, train[0], None).reshape(1),
           args.reps, dev, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
