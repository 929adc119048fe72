"""The GraphMixer slice as a whole: the example's flow in both packages.

Two epochs of train then val on the synthetic stream of 120 nodes and 800
edges (8-dim edge features, 20 TGB candidates per eval edge), split
70/15/15, batches of 96, the hook state reset after each epoch; then train
and val replayed through the hooks and test evaluated, as
``examples/linkproppred/graphmixer.py`` runs it: the shared feature-layout
recency hook (K = 5), one time-gap hook per split (a window of 100
events), static node features ``normal(N, 32)`` from the seed, time / embed
dims 8 / 16, dropout 0, Adam at lr 1e-3. Same weights (JAX's init, loaded
by ``load_graphmixer_params``). The frameworks draw different random
numbers, so the port is fed each draw of the JAX random-negative hook
(``neg``) and TGB hook (``neg_time``), replays included.

Bands: per-batch losses within 5e-3 and the first within 1e-5; val MRR
within 0.01 per epoch, test MRR within 0.02; the recency state exact after
each epoch; the frozen Time2Vec bit-equal to its init after training in
both packages. The measured gaps are printed. The port's example script
runs one epoch on the CPU, narrowed.
"""

import argparse
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from examples._datasets import load_dataset as j_load_dataset
from examples.linkproppred.graphmixer import GraphMixerEncoder as JGraphMixerEncoder
from tgm_tpu import DGDataLoader as JLoader
from tgm_tpu import DGraph as JDGraph
from tgm_tpu.constants import PADDED_NODE_ID
from tgm_tpu.eval.metrics import mrr_sum_count as j_mrr_sum_count
from tgm_tpu.hooks import HookManager as JHookManager
from tgm_tpu.hooks import RandomNegativeEdgeSamplerHook as JRandomNeg
from tgm_tpu.hooks import RecencyNeighborHook as JRecency
from tgm_tpu.hooks import TGBNegativeEdgeSamplerHook as JTGB
from tgm_tpu.hooks import TimeGapNeighborMeanHook as JTimeGap
from tgm_tpu.hooks import candidate_rows as j_candidate_rows
from tgm_tpu.hooks import seed_lookup as j_seed_lookup
from tgm_tpu.nn import LinkPredictor as JLinkPredictor
from tgm_tpu_torch.examples._datasets import load_dataset
from tgm_tpu_torch.examples.linkproppred import graphmixer as gm
from tgm_tpu_torch.weights import load_graphmixer_params

DATASET, EDGE_DIM, BSIZE, K, TIME, EMB, GAP = "synthetic-120-800", 8, 96, 5, 8, 16, 100
EPOCHS, LR, SEED = 2, 1e-3, 1337
SPLITS = ("train", "val", "test")


def args(**kw):
    base = dict(dataset=DATASET, seed=SEED, bsize=BSIZE, epochs=EPOCHS, lr=LR, dropout=0.0,
                n_nbrs=K, time_gap=GAP, time_dim=TIME, embed_dim=EMB, device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


def run_jax():
    """The JAX example's flow (examples/linkproppred/graphmixer.py:103-253) at
    the test's sizes; returns its init parameters, per-epoch losses, val
    MRR and recency state, the test MRR, every negative draw and its trained
    Time2Vec."""
    data, val_cands, test_cands = j_load_dataset(DATASET, edge_dim=EDGE_DIM)
    rng = np.random.default_rng(SEED)
    data.static_node_x = rng.normal(size=(data.num_nodes, 32)).astype(np.float32)
    num_nodes = data.num_nodes
    node_x = jnp.asarray(data.static_node_x)
    parts = dict(zip(SPLITS, data.split()))
    dgs = {k: JDGraph(d) for k, d in parts.items()}
    hm = JHookManager(keys=list(SPLITS))
    dst = dgs["train"].edge_dst
    hm.register("train", JRandomNeg(low=int(dst.min()), high=int(dst.max())))
    hm.register("val", JTGB(candidates=val_cands))
    hm.register("test", JTGB(candidates=test_cands))
    seed_keys = ["edge_src", "edge_dst", "neg"]
    time_keys = ["edge_time", "edge_time", "neg_time"]
    rec = JRecency(num_nodes, [K], seed_keys, time_keys, edge_dim=EDGE_DIM)
    hm.register_shared(rec)
    for key, dg in dgs.items():
        s_src, s_dst, s_t = dg._storage.get_edges(dg._slice)
        hm.register(key, JTimeGap(s_src, s_dst, s_t, node_x, GAP, seed_keys,
                                  edge_id_base=int(parts[key].edge_global_offset)))
    encoder = JGraphMixerEncoder(time_dim=TIME, embed_dim=EMB, num_tokens=K,
                                 node_dim=node_x.shape[1], edge_dim=EDGE_DIM, dropout=0.0)
    decoder = JLinkPredictor(node_dim=EMB, hidden_dim=EMB)
    opt = optax.adam(LR)
    hm.validate_requirement(encoder)
    with hm.activate("train"):
        b0 = next(iter(JLoader(dgs["train"], BSIZE, hook_manager=hm)))
    hm.reset_state()
    key = jax.random.PRNGKey(SEED)
    key, k1, k2 = jax.random.split(key, 3)
    params = {"enc": encoder.init(k1, b0, node_x),
              "dec": decoder.init(k2, jnp.zeros((1, EMB)), jnp.zeros((1, EMB)))}
    init_params = jax.tree_util.tree_map(np.asarray, params)
    opt_state = opt.init(params)

    @partial(jax.jit, donate_argnums=(1,))
    def train_step(params, opt_state, batch):
        B = batch.edge_src.shape[0]

        def loss_fn(p):
            z = encoder.apply(p["enc"], batch, node_x)
            pos = decoder.apply(p["dec"], z[:B], z[B:2 * B])
            neg = decoder.apply(p["dec"], z[:B], z[2 * B:3 * B])
            m = batch.edge_valid.astype(pos.dtype)
            d = jnp.maximum(m.sum(), 1.0)
            return (jnp.sum(optax.sigmoid_binary_cross_entropy(pos, jnp.ones_like(pos)) * m)
                    + jnp.sum(optax.sigmoid_binary_cross_entropy(neg, jnp.zeros_like(neg))
                              * m)) / d

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    @jax.jit
    def eval_step(params, batch):
        B = batch.edge_src.shape[0]
        Q = batch.neg_batch_list.shape[1]
        z = encoder.apply(params["enc"], batch, node_x)
        lut = j_seed_lookup(batch.seed_nids[0], node_x.shape[0])
        rows, found = j_candidate_rows(lut, batch.neg_batch_list, z.shape[0])
        pos = decoder.apply(params["dec"], z[:B], z[B:2 * B])
        neg = decoder.apply(params["dec"], jnp.repeat(z[:B][:, None, :], Q, 1).reshape(B * Q, -1),
                            z[rows].reshape(B * Q, -1)).reshape(B, Q)
        return j_mrr_sum_count(pos, neg,
                               neg_valid=(batch.neg_batch_list != PADDED_NODE_ID) & found,
                               edge_valid=batch.edge_valid)

    draws = {"neg": [], "neg_time": []}

    def batches(split):
        with hm.activate(split):
            for batch in JLoader(dgs[split], BSIZE, hook_manager=hm):
                if split == "train":
                    draws["neg"].append(np.asarray(batch.neg))
                else:
                    draws["neg_time"].append(np.asarray(batch.neg_time))
                yield batch

    def run_eval(split):
        s = c = 0.0
        for batch in batches(split):
            ds, dc = eval_step(params, batch)
            s, c = s + float(ds), c + float(dc)
        return s / max(c, 1.0)

    epochs = []
    for _ in range(EPOCHS):
        losses = []
        for batch in batches("train"):
            params, opt_state, loss = train_step(params, opt_state, batch)
            losses.append(float(loss))
        epochs.append(dict(losses=losses, val=run_eval("val"),
                           rec=[np.asarray(a) for a in rec.state]))
        hm.reset_state()
    for split in ("train", "val"):
        for _ in batches(split):
            pass
    test = run_eval("test")
    t2v = np.asarray(params["enc"]["params"]["Time2Vec_0"]["w"])
    return init_params, epochs, test, draws, t2v


def test_two_epochs_match_the_jax_example_flow():
    params, j_epochs, j_test, draws, j_t2v = run_jax()
    np.testing.assert_array_equal(j_t2v, params["enc"]["params"]["Time2Vec_0"]["w"])

    a = args()
    data, val_cands, test_cands = load_dataset(DATASET, edge_dim=EDGE_DIM)
    ctx = gm.build(a, data=data, cands=(val_cands, test_cands))
    load_graphmixer_params(params, ctx.encoder, ctx.decoder)
    t2v0 = [p.detach().clone() for p in ctx.encoder.time_encoder.parameters()]
    negs, neg_times = iter(draws["neg"]), iter(draws["neg_time"])
    ctx.setup.neg_hooks["train"].draw_neg = lambda size: torch.from_numpy(next(negs).copy())
    for split in ("val", "test"):
        ctx.setup.neg_hooks[split].draw_neg_time = (
            lambda n, lo, hi: torch.from_numpy(next(neg_times).copy()))
    rec_states = []
    p_out = gm.run(ctx, a, on_epoch_end=lambda e: rec_states.append(
        [t.clone() for t in ctx.recency.state]))
    assert next(negs, None) is None and next(neg_times, None) is None

    loss_gap = [np.abs(np.subtract(p, j["losses"])) for p, j in zip(p_out["losses"], j_epochs)]
    val_gap = max(abs(p - j["val"]) for p, j in zip(p_out["val_mrr"], j_epochs))
    test_gap = abs(p_out["test_mrr"] - j_test)
    losses = np.concatenate([j["losses"] for j in j_epochs])
    print(f"GraphMixer: {losses.size} train batches, first-loss gap {loss_gap[0][0]:.3g}, max "
          f"loss gap {max(g.max() for g in loss_gap):.3g}; val MRR "
          f"{[j['val'] for j in j_epochs]} (gap {val_gap:.3g}), test MRR {j_test:.6f} (gap "
          f"{test_gap:.3g})")
    assert losses.size == 2 * len(j_epochs[0]["losses"]) and len(j_epochs[0]["losses"]) >= 5
    assert loss_gap[0][0] <= 1e-5
    assert max(g.max() for g in loss_gap) <= 5e-3
    assert val_gap <= 0.01 and test_gap <= 0.02
    for e, (p, j) in enumerate(zip(rec_states, j_epochs)):
        assert len(p) == len(j["rec"])
        for i, (x, y) in enumerate(zip(p, j["rec"])):
            np.testing.assert_array_equal(x.numpy(), y, err_msg=f"epoch {e} recency tensor {i}")
    assert all(0.0 < v <= 1.0 for v in p_out["val_mrr"]) and 0.0 < p_out["test_mrr"] <= 1.0
    assert losses.max() - losses.min() > 1e-3  # the runs learned something
    # The frozen Time2Vec: zero gradient, so Adam leaves it bit-equal.
    for p, p0 in zip(ctx.encoder.time_encoder.parameters(), t2v0):
        assert torch.equal(p.detach(), p0)
    assert not torch.equal(ctx.encoder.link_proj.weight.detach(),
                           torch.tensor(np.asarray(params["enc"]["params"]["Dense_0"]["kernel"]).T))


def test_example_script_runs_one_epoch_on_the_cpu():
    out = gm.main(["--dataset", DATASET, "--device", "cpu", "--n-nbrs", "4", "--time-dim", "4",
                   "--embed-dim", "8", "--time-gap", "50"])
    assert np.isfinite(out["loss"][0]) and 0.0 < out["test_mrr"] <= 1.0
    assert len(out["losses"][0]) == 3  # ceil(560 train edges / 200)
