"""Plain PyTorch reference of ``tgn-wiki``: TGN (Rossi et al. 2020) in
eval as TGB's TGN baseline serves tgbl-wiki, written from its equations.
Imports neither JAX nor anything of the program under test; works out the
fold, the state, the hook products and the scores from the benchmark's
inputs alone.

Per batch: every seed (src, dst, each distinct candidate at its TGB link
time) gets its K most recent neighbours (``refcommon.recency``); its
embedding is graph attention over them (query: the seed's stored memory;
keys and values: the neighbour's memory plus ``lin_edge`` of [Time2Vec(the
seed's last update - the edge time) | edge features]; 2 heads; plus
``lin_skip``); a pair's score is the 2-layer MLP of [z_src | z_dst]; MRR
by TGB's tie rule. Then the batch folds in (eval order): each node's
message store keeps, per role, its latest event (earliest in the batch on
ties); each touched node's memory is GRU(memory, [memory | counterpart's
memory | edge features | Time2Vec(event time - last update)]) of the
winner across its two stores (src role on ties), with the memories read
before the batch's writes.

``fmt`` is the precision: "fp32" (TF32 off), or the control "tf32": every
matmul's operands rounded to TF32, the step below the configuration's fp32.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.yard import checks, evalplan, refcommon as rc
from portbench.yard.precision import mm
from portbench.yard.seeds import derive

FLOAT_STATE = ("mem",)
CONTROLS = ("tf32",)


def numbers(got, ref, limits) -> Dict[str, float]:
    """The numbers compared: those of every link-prediction eval cell (a
    rank decision free within the score limit), ``score_gap``, the kept
    scores' max abs gap over their max abs, and ``state_gap``, the
    memory's."""
    n = checks.linkpred_numbers(got, ref, limits["score_gap"], FLOAT_STATE)
    n["score_gap"] = checks.kept_score_gap(got, ref)
    n["state_gap"] = max(checks.rel_gap(got["state"][k], ref["state"][k]) for k in FLOAT_STATE)
    return n


def run(cfg, stream, cands, traffic, seed: int, W: Dict[str, torch.Tensor], plan: evalplan.Plan,
        device, fmt: str = "fp32") -> Dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fmt = {"fp32": "fp32", "tf32": "tf32"}[fmt]
    W = {k: v.to(device).float() for k, v in W.items()}
    N, M, K, H = stream.num_nodes, cfg["memory_dim"], cfg["num_neighbors"], cfg["num_heads"]
    T, E = cfg["time_dim"], cfg["embedding_dim"]
    Bsz = traffic["protocol"]["batch_size"]
    lin = lambda x, p, bias=True: mm(x, W[f"{p}.weight"].T, fmt) + (W[f"{p}.bias"] if bias else 0)
    src_all = torch.as_tensor(stream.src, device=device).long()
    dst_all = torch.as_tensor(stream.dst, device=device).long()
    t_all = torch.as_tensor(stream.t, device=device).long()
    x_all = torch.as_tensor(stream.edge_x, device=device)
    batches, batch_of = evalplan.walk(stream.bounds, Bsz)
    log = rc.build_log(stream.src, stream.dst, stream.t, batch_of, len(batches), device)
    tables = {k: torch.as_tensor(v, device=device).long() for k, v in cands.items()}
    gens = {k: torch.Generator().manual_seed(derive(seed, f"{k}_times")) for k in ("val", "test")}

    i32 = dict(dtype=torch.int64, device=device)
    st = {
        "mem": torch.zeros((N, M), device=device), "last_update": torch.zeros(N, **i32),
        "s_other": torch.full((N,), -1, **i32), "s_t": torch.zeros(N, **i32),
        "s_raw": torch.zeros((N, x_all.shape[1]), device=device),
        "s_valid": torch.zeros(N, dtype=torch.bool, device=device),
        "d_other": torch.full((N,), -1, **i32), "d_t": torch.zeros(N, **i32),
        "d_raw": torch.zeros((N, x_all.shape[1]), device=device),
        "d_valid": torch.zeros(N, dtype=torch.bool, device=device),
    }

    def gru(h, x):
        gi = mm(x, W["memory.gru.weight_ih"].T, fmt) + W["memory.gru.bias_ih"]
        gh = mm(h, W["memory.gru.weight_hh"].T, fmt) + W["memory.gru.bias_hh"]
        r = torch.sigmoid(gi[:, :M] + gh[:, :M])
        z = torch.sigmoid(gi[:, M:2 * M] + gh[:, M:2 * M])
        n = torch.tanh(gi[:, 2 * M:] + r * gh[:, 2 * M:])
        return (1 - z) * n + z * h

    def store(role, nodes, other, t, x):
        # Latest event per node, earliest position on ties.
        order = torch.sort(-t, stable=True).indices
        order = order[torch.sort(nodes[order], stable=True).indices]
        first = torch.ones_like(order, dtype=torch.bool)
        first[1:] = nodes[order][1:] != nodes[order][:-1]
        w = order[first]
        n = nodes[w]
        st[f"{role}_other"][n] = other[w]
        st[f"{role}_t"][n] = t[w]
        st[f"{role}_raw"][n] = x[w]
        st[f"{role}_valid"][n] = True

    def commit(lo, hi):
        src, dst, t, x = src_all[lo:hi], dst_all[lo:hi], t_all[lo:hi], x_all[lo:hi]
        store("s", src, dst, t, x)
        store("d", dst, src, t, x)
        n = torch.unique(torch.cat([src, dst]))
        ts = torch.where(st["s_valid"][n], st["s_t"][n], -1)
        td = torch.where(st["d_valid"][n], st["d_t"][n], -1)
        use_d = td > ts
        other = torch.where(use_d, st["d_other"][n], st["s_other"][n])
        tw = torch.where(use_d, st["d_t"][n], st["s_t"][n])
        raw = torch.where(use_d[:, None], st["d_raw"][n], st["s_raw"][n])
        enc = rc.time2vec(W["memory.time_enc.w.weight"][:, 0], W["memory.time_enc.w.bias"],
                          tw - st["last_update"][n])
        h = st["mem"][n]
        msg = torch.cat([h, st["mem"][other], raw, enc], dim=1)
        st["mem"][n] = gru(h, msg)
        st["last_update"][n] = torch.maximum(ts, td).clamp_min(0)
        return n.shape[0]

    def embed(seeds, taus, gidx):
        nbr, nt, ne = rc.recency(log, seeds, taus, gidx, K, K)
        nx = torch.where((ne >= 0)[..., None], x_all[ne.clamp_min(0)], 0.0)
        valid = nbr >= 0
        S = seeds.shape[0]
        xs = torch.where((seeds >= 0)[:, None], st["mem"][seeds.clamp_min(0)], 0.0)
        ls = torch.where(seeds >= 0, st["last_update"][seeds.clamp_min(0)], 0)
        xn = torch.where(valid[..., None], st["mem"][nbr.clamp_min(0)], 0.0)
        tf = rc.time2vec(W["encoder.time_enc.w.weight"][:, 0], W["encoder.time_enc.w.bias"],
                         ls[:, None] - nt)
        e = (mm(tf.reshape(S * K, T), W["encoder.lin_edge.weight"][:, :T].T, fmt)
             + mm(nx.reshape(S * K, -1), W["encoder.lin_edge.weight"][:, T:].T, fmt))
        C = E // H
        q = lin(xs, "encoder.lin_query").reshape(S, 1, H, C)
        k = (lin(xn.reshape(S * K, M), "encoder.lin_key") + e).reshape(S, K, H, C)
        v = (lin(xn.reshape(S * K, M), "encoder.lin_value") + e).reshape(S, K, H, C)
        logits = (q * k).sum(-1) * C ** -0.5
        logits = torch.where(valid[..., None], logits, -1e10)
        a = torch.softmax(logits, dim=1) * valid[..., None]
        z = (a[..., None] * v).sum(1).reshape(S, E) + lin(xs, "encoder.lin_skip")
        return z, (seeds, taus, nbr, nt, nx)

    def decode(zs, zd):
        h = torch.relu(lin(torch.cat([zs, zd], dim=-1), "decoder.model.0"))
        return lin(h, "decoder.model.2")[..., 0]

    out = {"mrr": {}, "scores": {}, "products": {}, "counts": {}, "sizes": {}, "state": None}
    R = plan.keep_rows
    for b in batches:
        if b.split == "train":
            commit(b.lo, b.hi)
            continue
        n = b.hi - b.lo
        key = (b.split, b.index)
        src, dst, t = src_all[b.lo:b.hi], dst_all[b.lo:b.hi], t_all[b.lo:b.hi]
        rows = tables[b.split][b.row0:b.row0 + n]
        u = torch.unique(rows)
        Q = rows.shape[1]
        neg_t = rc.tgb_neg_times(gens[b.split], Bsz * Q, u.shape[0], int(t.min()),
                                 int(t.max())).to(device)
        real = torch.cat([src, dst, u])
        if key in plan.scored:
            pad = lambda x, fill: torch.cat([x, torch.full((Bsz - n,), fill, **i32)])
            seeds = torch.cat([pad(src, -1), pad(dst, -1), u])
            taus = torch.cat([pad(t, 0), pad(t, 0), neg_t])
            z, prods = embed(seeds, taus, b.gidx)
            zs, zd, zu = z[:n], z[Bsz:Bsz + n], z[2 * Bsz:]
            zc = zu[torch.searchsorted(u, rows)]
            pos = decode(zs, zd)
            neg = decode(zs[:, None, :].expand(-1, Q, -1), zc)
            out["mrr"][key] = (float(rc.mrr_sum(pos, neg)), float(n))
            out["scores"][key] = torch.cat([pos[:, None], neg], dim=1).cpu()
            if key in plan.samples:
                fill = R - seeds.shape[0]
                ext = lambda x, f: (torch.cat([x, torch.full((fill,) + x.shape[1:], f,
                                                             dtype=x.dtype, device=device)])
                                    if fill > 0 else x[:R])
                out["products"][key] = {
                    "seed_nids": ext(seeds, -1).cpu(), "seed_times": ext(taus, 0).cpu(),
                    "nbr_nids": ext(prods[2], -1).cpu(), "nbr_edge_time": ext(prods[3], 0).cpu(),
                    "nbr_edge_x": ext(prods[4], 0.0).cpu()}
        valid_nbrs = int((rc.recency(log, real, torch.cat([t, t, neg_t]), b.gidx, K, K)[0]
                          >= 0).sum())
        touched = commit(b.lo, b.hi)
        out["counts"][key] = float(n)
        out["sizes"][key] = {"edges": n, "real_seeds": int(real.shape[0]),
                             "valid_nbrs": valid_nbrs, "scored_pairs": n * (Q + 1),
                             "touched_nodes": touched}
        if plan.end == key:
            out["state"] = _state(st, log, N, b.gidx + 1, K, x_all)
    return out


def _state(st, log, N, after, K, x_all):
    ids, times, eids = rc.ring_state(log, N, after, K)
    s = {k: v.detach().cpu().clone() for k, v in st.items()}
    s.update(ring_ids=ids.cpu(), ring_times=times.cpu(), ring_payload=eids.cpu())
    return s
