"""The DyGFormer serving slice as a whole: a JAX eval core against the port's.

A small stream (100 nodes, 600 edges with 6-dim features, batch 50, 4
candidates per edge, K = 5 recency neighbours in the feature-buffer layout,
DyGFormer with channel dim 8, so D = 32, 2 heads, sequences of 8, output
16) made with numpy from a seed runs through the val and test splits on
both packages on the CPU, with uniform and with zipf node popularity, with
the same weights (JAX's init, loaded by ``load_dygformer_params``) and the
same candidates. The JAX side is the eval core of
``examples/linkproppred/dygformer.py`` with the Pallas stack
(``pallas_layers``, interpret mode); the port runs ``hook_epoch`` with
``build_dygformer_eval_core``. The TGB hook's fake link times come from each
package's own generator, so the port is fed the JAX hook's ``neg_time``.

Tolerances: recency state exact (the fp32 feature buffer included);
scores within 1e-2 * max |JAX score| (the stack's bf16 rounding flips, see
``test_torch_dyg_transformer.py``, move embeddings by up to a few 1e-3);
per-batch MRR sums within 1e-4, plus 0.5 for each candidate that the two
packages order differently against its positive, which must be a near tie
(gap within the score tolerance) on both sides. Over the two streams one
candidate flips (uniform stream: a gap of 6e-4, per-batch sums 0.5 apart);
the test allows at most two. The JAX core makes two encoder calls
(positives, then candidates), the port one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgm_tpu import DGData as JDGData
from tgm_tpu import DGraph as JDGraph
from tgm_tpu.constants import PADDED_NODE_ID
from tgm_tpu.eval.metrics import mrr_sum_count
from tgm_tpu.hooks import HookManager as JHookManager
from tgm_tpu.hooks import RecencyNeighborHook as JRecency
from tgm_tpu.hooks import TGBNegativeEdgeSamplerHook as JTGB
from tgm_tpu.hooks import candidate_rows, seed_lookup
from tgm_tpu.nn import DyGFormer as JDyGFormer
from tgm_tpu.nn import LinkPredictor as JLinkPredictor
from tgm_tpu.nn.encoder.dygformer import dygformer_pallas_layers
from tgm_tpu.train import DeviceEdgeStream as JStream
from tgm_tpu_torch import DGData, DGraph
from tgm_tpu_torch.hooks import HookManager, RecencyNeighborHook, TGBNegativeEdgeSamplerHook
from tgm_tpu_torch.nn import DyGFormer, LinkPredictor
from tgm_tpu_torch.train import DeviceEdgeStream, build_dygformer_eval_core, hook_epoch
from tgm_tpu_torch.weights import load_dygformer_params

N, E, BSIZE, Q, K, EDGE_DIM = 100, 600, 50, 4, 5, 6
DYG = dict(node_feat_dim=1, edge_x_dim=EDGE_DIM, time_feat_dim=8, channel_embedding_dim=8,
           output_dim=16, patch_size=1, max_input_sequence_length=8)


def make_stream(popularity, seed=0):
    rng = np.random.default_rng(seed)
    pop = None
    if popularity == "zipf":
        pop = rng.zipf(1.4, size=N).astype(np.float64)
        pop /= pop.sum()
    src = rng.choice(N, E, p=pop)
    dst = rng.choice(N, E, p=pop)
    dst = np.where(dst == src, (dst + 1) % N, dst)
    t = np.sort(rng.integers(0, 2 * E, E))  # repeated times: ties inside batches
    edge_x = rng.normal(size=(E, EDGE_DIM)).astype(np.float32)
    node_x = rng.normal(size=(N, 1)).astype(np.float32)
    return src, dst, t, edge_x, node_x, rng, pop


def hooks(jax_side, cands, device=None):
    keys = (["edge_src", "edge_dst", "neg"], ["edge_time", "edge_time", "neg_time"])
    if jax_side:
        hm = JHookManager(keys=["val", "test"])
        for split in ("val", "test"):
            hm.register(split, JTGB(candidates=cands[split]))
        rec = JRecency(N, [K], *keys, edge_dim=EDGE_DIM)
    else:
        hm = HookManager(keys=["val", "test"])
        for split in ("val", "test"):
            hm.register(split, TGBNegativeEdgeSamplerHook(cands[split], device=device))
        rec = RecencyNeighborHook(N, [K], *keys, edge_dim=EDGE_DIM, device=device)
    hm.register_shared(rec)
    return hm, rec


def jax_eval_core(encoder, decoder, node_x, pl):
    """``examples/linkproppred/dygformer.py::eval_core`` with the Pallas stack."""

    def eval_core(params, batch):
        B = batch.edge_src.shape[0]
        Qb = batch.neg_batch_list.shape[1]
        nbr, nt, nx = batch.nbr_nids[0], batch.nbr_edge_time[0], batch.nbr_edge_x[0]
        cat = lambda a: jnp.concatenate([a[:B], a[B:2 * B]])
        zs, zd = encoder.apply(params["enc"], node_x, batch.edge_src, batch.edge_dst,
                               batch.edge_time, cat(nbr), cat(nt), cat(nx), pallas_layers=pl)
        pos = decoder.apply(params["dec"], zs, zd)
        negs = batch.neg_batch_list.reshape(-1)
        lut = seed_lookup(batch.seed_nids[0], node_x.shape[0])
        rows, found = candidate_rows(lut, negs, nbr.shape[0])
        rep = lambda a: jnp.concatenate([jnp.repeat(a[:B], Qb, axis=0), a[rows]])
        zs2, zn = encoder.apply(params["enc"], node_x, jnp.repeat(batch.edge_src, Qb), negs,
                                jnp.repeat(batch.edge_time, Qb), rep(nbr), rep(nt), rep(nx),
                                pallas_layers=pl)
        neg = decoder.apply(params["dec"], zs2, zn).reshape(B, Qb)
        neg_valid = (batch.neg_batch_list != PADDED_NODE_ID) & found.reshape(B, Qb)
        s, c = mrr_sum_count(pos, neg, neg_valid=neg_valid, edge_valid=batch.edge_valid)
        return params, (s, c, pos, neg, neg_valid & batch.edge_valid[:, None])

    return eval_core


def run_jax(src, dst, t, edge_x, node_x, cands):
    data = JDGData.from_raw(t, np.stack([src, dst], 1), edge_x)
    _, val, test = data.split()
    dgs = {"val": JDGraph(val), "test": JDGraph(test)}
    hm, rec = hooks(True, cands)
    encoder = JDyGFormer(dropout=0.0, **DYG)
    decoder = JLinkPredictor(node_dim=16, hidden_dim=16)
    z = lambda *s: jnp.zeros(s, jnp.int32)
    params = {"enc": encoder.init(jax.random.PRNGKey(3), jnp.asarray(node_x), z(4), z(4), z(4),
                                  z(8, K), z(8, K), jnp.zeros((8, K, EDGE_DIM))),
              "dec": decoder.init(jax.random.PRNGKey(4), jnp.zeros((1, 16)), jnp.zeros((1, 16)))}
    eval_core = jax_eval_core(encoder, decoder, jnp.asarray(node_x),
                              dygformer_pallas_layers(params["enc"], 2))
    sums, neg_times, batch_scores = [], [], []
    for split in ("val", "test"):
        stream = JStream(dgs[split], BSIZE)
        fn, states = hm.as_transform(split, dgs[split])

        @jax.jit
        def step(states, i):
            states, batch = fn(states, stream.batch_at(i))
            _, (s, _, pos, neg, valid) = eval_core(params, batch)
            return states, s, batch.neg_time, pos, neg, valid

        for i in range(stream.num_batches):
            states, s, nt, *scores = step(states, i)
            sums.append(float(s))
            neg_times.append(np.asarray(nt))
            batch_scores.append([np.asarray(x) for x in scores])
        hm.adopt_states(split, states)
    return params, rec.state, sums, neg_times, batch_scores


def run_port(src, dst, t, edge_x, node_x, cands, params, neg_times):
    data = DGData.from_raw(t, np.stack([src, dst], 1), edge_x)
    _, val, test = data.split()
    dgs = {"val": DGraph(val), "test": DGraph(test)}
    hm, rec = hooks(False, cands, device="cpu")
    injected = iter(neg_times)
    for split in ("val", "test"):
        tgb = hm._key_to_hooks[split][0]
        tgb.draw_neg_time = lambda n, lo, hi: torch.from_numpy(next(injected).copy())
    encoder, decoder = DyGFormer(**DYG), LinkPredictor(node_dim=16, hidden_dim=16)
    load_dygformer_params(params, encoder, decoder)
    eval_core = build_dygformer_eval_core(encoder.eval(), decoder.eval(),
                                          torch.from_numpy(node_x), N)
    scores = []

    def step(carry, batch):
        """``eval_core``, which is ``score(batch, *embed(batch))``, keeping the scores."""
        B = batch.edge_src.shape[0]
        z = eval_core.embed(batch)
        with torch.no_grad():
            sc = decoder(*z)
        scores.append((sc[:B].numpy(), sc[B:].reshape(B, -1).numpy()))
        return carry, eval_core.score(batch, *z)

    sums = []
    for split in ("val", "test"):
        stream = DeviceEdgeStream(dgs[split], BSIZE, device="cpu")
        epoch, states = hook_epoch(stream, hm, split, dgs[split], step)
        _, states, (s, c) = epoch(None, states)
        hm.adopt_states(split, states)
        sums += s.tolist()
    return rec.state, sums, scores


@pytest.mark.parametrize("popularity", ["uniform", "zipf"])
def test_dygformer_slice_matches_jax_eval_core(popularity):
    src, dst, t, edge_x, node_x, rng, pop = make_stream(popularity)
    val_t = int((t[-1] + 1) * 0.7)
    test_t = val_t + int((t[-1] + 1) * 0.15)
    n_val = int(((t >= val_t) & (t < test_t)).sum())
    n_test = int((t >= test_t).sum())
    cands = {"val": rng.choice(N, (n_val, Q), p=pop), "test": rng.choice(N, (n_test, Q), p=pop)}
    assert n_val % BSIZE and n_test % BSIZE  # padded tail batches in both splits

    params, j_rec, j_sums, neg_times, j_scores = run_jax(src, dst, t, edge_x, node_x, cands)
    rec, sums, scores = run_port(src, dst, t, edge_x, node_x, cands, params, neg_times)

    assert len(sums) == len(j_sums) >= 4
    for got, want in zip(rec, j_rec):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    n_flips = 0
    for (pos, neg), (j_pos, j_neg, valid), got, want in zip(scores, j_scores, sums, j_sums):
        tol = 1e-2 * max(np.abs(j_pos).max(), np.abs(j_neg).max())
        assert np.abs(pos - j_pos).max() <= tol and np.abs(neg - j_neg).max() <= tol
        # Candidates ordered differently against their positive by the two
        # packages: each must be a near tie on both sides, and each moves
        # its edge's reciprocal rank by at most 0.5.
        order = lambda p, n: np.sign(n - p[:, None])
        flipped = (order(pos, neg) != order(j_pos, j_neg)) & valid
        assert (np.abs(neg - pos[:, None])[flipped] <= tol).all()
        assert (np.abs(j_neg - j_pos[:, None])[flipped] <= tol).all()
        assert abs(got - want) <= 1e-4 + 0.5 * flipped.sum()
        n_flips += int(flipped.sum())
    assert n_flips <= 2
    # The buffers carry features, and the scores are not all tied.
    assert np.abs(rec[2].numpy()).max() > 0.5
    assert 0.0 < sum(sums) < len(sums) * BSIZE
