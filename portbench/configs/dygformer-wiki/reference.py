"""Plain PyTorch reference of ``dygformer-wiki``: DyGFormer (Yu et al.
2023) in eval, written from its equations. Imports neither JAX nor
anything of the program under test; works out the recency state, the hook
products and the scores from the benchmark's inputs alone.

A pair (a, b) at the positive edge's time tau: each side is the sequence
[seed, its K most recent neighbours (``refcommon.recency``; a candidate's
queried at its TGB link time)], padded with PAD to L (DyGLib: K = L - 1,
so only nodes with fewer than K neighbours are padded). Four channels a
token: the node feature, the edge features (zero at the seed), Time2Vec
(tau - the event time) (zero on PAD), and the co-occurrence encoding
(each token's count in its own and in the other sequence, zero on PAD,
each through Linear -> ReLU -> Linear, summed), each projected to C. The
2L tokens of width 4C run through the pre-LN transformer stack; each side
is mean-pooled over its L tokens and projected by ``output_layer``; the
score is the 2-layer MLP of [z_a | z_b]; MRR by TGB's tie rule.

Precision, ``fmt``: "fp32" is the configuration's. The stack computes in
bf16: the LayerNorm outputs, the weights, q, k, v, the softmax
probabilities, the head outputs and the gelu output are matmul operands
rounded to bf16, sums fp32; LayerNorm (eps 1e-5), softmax and the residual
stream fp32; exact gelu. Every other matmul ("the rest": the channel
projections, the co-occurrence encoder, the output layer, the decoder) is
fp32. The controls (``CONTROLS``) lower one part a step: "stack_fp8" (fp8
e4m3 with a per-tensor scale in place of bf16), "rest_tf32" (TF32 operands
for the rest) and "rest_bf16" (bf16 operands for the rest).

``numbers`` compares, besides what every link-prediction cell compares:
``score_rms_gap``, the kept scores' rms gap over their rms (the bf16
stack's roundings flip between summation orders, so a maximum gap swings
from seed to seed; the rms is steady); and the fp32 layers on their own:
``feat_gap``, the kept pairs' channel projections (the stack's input)
against this reference's, and ``head_gap``, the program's scores against
the output layer and decoder of this reference applied to the program's
own pooled stack output.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.yard import checks, evalplan, refcommon as rc
from portbench.yard.precision import ROUND, mm
from portbench.yard.seeds import derive

CHUNK = 4_200  # pairs a block through the stack: one batch of 200 x (1 + 20)
CHANNELS = ("proj_node", "proj_edge", "proj_time", "proj_cooc")
# How far a score may move before a rank decision counts as made: 3.4x
# the largest max-abs gap of a sound run's kept scores (5.35e-3, 29 runs).
SCORE_TIE_TOL = 0.018
FORMATS = {"fp32": ("bf16", "fp32"), "stack_fp8": ("fp8", "fp32"),
           "rest_tf32": ("bf16", "tf32"), "rest_bf16": ("bf16", "bf16")}
CONTROLS = ("stack_fp8", "rest_tf32", "rest_bf16")


def numbers(got, ref, limits) -> Dict[str, float]:
    n = checks.linkpred_numbers(got, ref, SCORE_TIE_TOL)
    n["score_rms_gap"] = checks.kept_score_gap(got, ref, checks.rms_gap)
    feat, head = [], []
    for key, caps in got["captures"].items():
        mine = ref["captures"].get(key, {})
        for name, t in caps.items():
            if name.split(".")[0] in CHANNELS:
                feat.append(checks.rel_gap(t, mine[name]) if name in mine else float("inf"))
        head.append(checks.rel_gap(caps["scores.0"].reshape(-1),
                                   ref["head"](caps["pooled.0"]).reshape(-1)))
    n["feat_gap"] = max(feat) if feat else float("nan")
    n["head_gap"] = max(head) if head else float("nan")
    return n


def run(cfg, stream, cands, traffic, seed: int, W: Dict[str, torch.Tensor], plan: evalplan.Plan,
        device, fmt: str = "fp32") -> Dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stack_fmt, rest_fmt = FORMATS[fmt]
    W = {k: v.to(device).float() for k, v in W.items()}
    N, K, L = stream.num_nodes, cfg["num_neighbors"], cfg["max_input_sequence_length"]
    C, H = cfg["channel_embedding_dim"], cfg["num_heads"]
    Bsz = traffic["protocol"]["batch_size"]
    P = "encoder."
    lin = lambda x, p: mm(x, W[f"{p}.weight"].T, rest_fmt) + W[f"{p}.bias"]
    src_all = torch.as_tensor(stream.src, device=device).long()
    dst_all = torch.as_tensor(stream.dst, device=device).long()
    t_all = torch.as_tensor(stream.t, device=device).long()
    x_all = torch.as_tensor(stream.edge_x, device=device)
    node_x = W["node_x"]
    batches, batch_of = evalplan.walk(stream.bounds, Bsz)
    log = rc.build_log(stream.src, stream.dst, stream.t, batch_of, len(batches), device)
    tables = {k: torch.as_tensor(v, device=device).long() for k, v in cands.items()}
    gens = {k: torch.Generator().manual_seed(derive(seed, f"{k}_times")) for k in ("val", "test")}

    def side(seed_ids, tau, nbr, nt, nx):
        """(R, L) ids, times and (R, L, De) features of [seed | neighbours], PAD after."""
        R = seed_ids.shape[0]
        pad = L - 1 - K
        ids = torch.cat([seed_ids[:, None], nbr, torch.full((R, pad), -1, dtype=nbr.dtype,
                                                               device=device)], 1)
        ts = torch.cat([tau[:, None], nt, torch.zeros((R, pad), dtype=nt.dtype, device=device)], 1)
        fs = torch.cat([torch.zeros((R, 1, nx.shape[2]), device=device), nx,
                        torch.zeros((R, pad, nx.shape[2]), device=device)], 1)
        return ids, ts, fs

    def cooc(a, b):
        """Encoded (own, other) counts of each token of ``a`` (R, L, C)."""
        own = (a[:, :, None] == a[:, None, :]).sum(2)
        other = (a[:, :, None] == b[:, None, :]).sum(2)
        f = torch.stack([own, other], 2).float() * (a >= 0)[..., None]
        w0 = ROUND[rest_fmt](W[P + "co_occurrence_encoder.enc.0.weight"][:, 0])
        h = torch.relu(f[..., None] * w0 + W[P + "co_occurrence_encoder.enc.0.bias"])
        return lin(h, P + "co_occurrence_encoder.enc.2").sum(2)

    def channels(ids, ts, fs, tau, cc):
        valid = (ids >= 0)[..., None]
        nf = torch.where(valid, node_x[ids.clamp_min(0)], 0.0)
        tf = torch.where(valid, rc.time2vec(W[P + "time_encoder.w.weight"][:, 0],
                                            W[P + "time_encoder.w.bias"], tau[:, None] - ts), 0.0)
        return [lin(nf, P + "proj_node"), lin(fs, P + "proj_edge"),
                lin(tf, P + "proj_time"), lin(cc, P + "proj_cooc")]

    def layer_norm(x, p):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + 1e-5) * W[f"{p}.weight"] + W[f"{p}.bias"]

    def stack(h):
        r = ROUND[stack_fmt]
        R, S, D = h.shape
        dh = D // H
        for i in range(cfg["num_layers"]):
            p = f"{P}transformers.{i}."
            a = r(layer_norm(h, p + "ln1"))
            q, k, v = (r(mm(a, W[p + f"attn.{n}.weight"].T, stack_fmt) + W[p + f"attn.{n}.bias"])
                       .reshape(R, S, H, dh).transpose(1, 2) for n in ("query", "key", "value"))
            att = r(torch.softmax((q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(dh)), dim=-1))
            o = r((att @ v).transpose(1, 2).reshape(R, S, D))
            h = h + mm(o, W[p + "attn.out.weight"].T, stack_fmt) + W[p + "attn.out.bias"]
            a = r(layer_norm(h, p + "ln2"))
            g = r(torch.nn.functional.gelu(mm(a, W[p + "ffn1.weight"].T, stack_fmt)
                                           + W[p + "ffn1.bias"]))
            h = h + mm(g, W[p + "ffn2.weight"].T, stack_fmt) + W[p + "ffn2.bias"]
        return h

    def project(A, Bs, tau):
        """The eight channel projections: side a's four, then side b's."""
        ca, cb = cooc(A[0], Bs[0]), cooc(Bs[0], A[0])
        return channels(*A, tau, ca) + channels(*Bs, tau, cb)

    def pooled(A, Bs, tau):
        """Each side's mean of the stack's output, (R, D) twice."""
        parts = project(A, Bs, tau)
        h = stack(torch.cat([torch.cat(parts[:4], -1), torch.cat(parts[4:], -1)], 1))
        return h[:, :L].mean(1), h[:, L:].mean(1)

    def decode(za, zb):
        h = torch.relu(lin(torch.cat([za, zb], -1), "decoder.model.0"))
        return lin(h, "decoder.model.2")[..., 0]

    def head(pool):
        """Scores of the pairs from [side a's pooled rows | side b's]."""
        z = lin(pool.to(device).float(), P + "output_layer")
        R = z.shape[0] // 2
        return decode(z[:R], z[R:]).cpu()

    out = {"mrr": {}, "scores": {}, "products": {}, "counts": {}, "sizes": {}, "state": None,
           "captures": {}, "head": head}
    R_keep = plan.keep_rows
    i64 = dict(dtype=torch.int64, device=device)
    for b in batches:
        if b.split == "train":
            continue
        n = b.hi - b.lo
        key = (b.split, b.index)
        src, dst, t = src_all[b.lo:b.hi], dst_all[b.lo:b.hi], t_all[b.lo:b.hi]
        rows = tables[b.split][b.row0:b.row0 + n]
        Q = rows.shape[1]
        u = torch.unique(rows)
        neg_t = rc.tgb_neg_times(gens[b.split], Bsz * Q, u.shape[0], int(t.min()),
                                 int(t.max())).to(device)
        padn = lambda x, fill: torch.cat([x, torch.full((Bsz - n,), fill, **i64)])
        seeds = torch.cat([padn(src, -1), padn(dst, -1), u])
        taus = torch.cat([padn(t, 0), padn(t, 0), neg_t])
        nbr, nt, ne = rc.recency(log, seeds, taus, b.gidx, K, K)
        if key in plan.scored:
            nx = torch.where((ne >= 0)[..., None], x_all[ne.clamp_min(0)], 0.0)
            # Pairs: (src, dst) for each edge, then (src, candidate q) row-major.
            ar = torch.arange(n, device=device)
            ia = torch.cat([ar, ar.repeat_interleave(Q)])
            ib = torch.cat([Bsz + ar, 2 * Bsz + torch.searchsorted(u, rows.reshape(-1))])
            tau = t[ia]
            sides = lambda i, tc: (side(seeds[ia[i]], tc, nbr[ia[i]], nt[ia[i]], nx[ia[i]]),
                                   side(seeds[ib[i]], tc, nbr[ib[i]], nt[ib[i]], nx[ib[i]]))
            pa, pb = [], []
            for c0 in range(0, ia.shape[0], CHUNK):
                i = torch.arange(c0, min(c0 + CHUNK, ia.shape[0]), device=device)
                a, b_ = pooled(*sides(i, tau[i]), tau[i])
                pa.append(a)
                pb.append(b_)
            za = lin(torch.cat(pa), P + "output_layer")
            zb = lin(torch.cat(pb), P + "output_layer")
            sc = decode(za, zb)
            pos, neg = sc[:n], sc[n:].reshape(n, Q)
            out["mrr"][key] = (float(rc.mrr_sum(pos, neg)), float(n))
            out["scores"][key] = torch.cat([pos[:, None], neg], 1).cpu()
            if key in plan.samples:
                caps = {"pooled.0": torch.cat(pa + pb).cpu(), "scores.0": sc.cpu()}
                if plan.capture_rows:
                    # The program's pair order: B positive rows (PAD ones past
                    # n), then the candidates; NaN where it has no such pair.
                    r = torch.arange(min(plan.capture_rows, Bsz * (Q + 1)), device=device)
                    idx = torch.where(r < n, r, torch.where(
                        (r >= Bsz) & (r - Bsz < n * Q), n + r - Bsz, -1))
                    i = idx.clamp_min(0)
                    parts = project(*sides(i, tau[i]), tau[i])
                    for j, t_ in enumerate(parts):
                        t_ = torch.where((idx >= 0)[:, None, None], t_, float("nan"))
                        caps[f"{CHANNELS[j % 4]}.{j // 4}"] = t_.cpu()
                out["captures"][key] = caps
                fill = R_keep - seeds.shape[0]
                ext = lambda x, f: (torch.cat([x, torch.full((fill,) + x.shape[1:], f,
                                                             dtype=x.dtype, device=device)])
                                    if fill > 0 else x[:R_keep])
                out["products"][key] = {
                    "seed_nids": ext(seeds, -1).cpu(), "seed_times": ext(taus, 0).cpu(),
                    "nbr_nids": ext(nbr, -1).cpu(), "nbr_edge_time": ext(nt, 0).cpu(),
                    "nbr_edge_x": ext(nx, 0.0).cpu()}
        real = torch.cat([torch.arange(n, device=device), Bsz + torch.arange(n, device=device),
                          2 * Bsz + torch.arange(u.shape[0], device=device)])
        out["counts"][key] = float(n)
        out["sizes"][key] = {"edges": n, "real_seeds": int(real.shape[0]),
                             "valid_nbrs": int((nbr[real] >= 0).sum()),
                             "scored_pairs": n * (Q + 1)}
        if plan.end == key:
            ids, times, eids = rc.ring_state(log, N, b.gidx + 1, K)
            feats = torch.where((eids >= 0)[..., None], x_all[eids.clamp_min(0)], 0.0)
            out["state"] = {"ring_ids": ids.cpu(), "ring_times": times.cpu(),
                            "ring_payload": feats.cpu()}
    return out
