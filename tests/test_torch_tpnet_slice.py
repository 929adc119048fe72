"""The TPNet slice as a whole: both examples' flows in both packages.

Link (``examples/linkproppred/tpnet.py`` through ``_linkpred_common``):
the synthetic stream of 120 nodes and 800 edges (172-dim edge features, 20
TGB candidates per eval edge), split 70/15/15, batches of 96, two epochs
(the RP state re-initialised at each epoch's start, backed up after train,
the hooks reset between epochs), then test from the reloaded backup.
Node (``examples/nodeproppred/tpnet.py``): the same stream with 8-dim edge
features and 4 label classes, batches of 16 events (some without a
label), two epochs, test after the
last val. Both: the shared feature-layout recency hook (K = 5), time /
embed dims 8 / 16, random projections of 2 layers and 64 columns (decay
1e-6), dropout 0, Adam at lr 1e-3 (link) and 1e-4 (node, the example's
default: at 1e-3 its one-label batches amplify roundings past 5e-3 within
an epoch, in both directions between the packages), static node features
``normal(N, 8)`` from the seed. Same weights (JAX's init, ``load_tpnet_params``) and the
same RP layer 0 (JAX's ``jax.random`` draw, ``rp_state_from_numpy``); the
port is fed each draw of the JAX random-negative hook (``neg``) and TGB
hook (``neg_time``).

Bands: per-batch losses within 5e-3 and the first within 1e-5; val within
0.01 per epoch and test within 0.02 (MRR or NDCG); after each epoch's val
the RP state within 1e-5 * max |P| and the recency state exact. ROADMAP
faults 18 and 19 are pinned: link test starts from the RP backup taken
after train while the recency hook has seen val; node batches without
labels move no RP state. The two masks of TPNet's paired train calls are
equal. The examples' scripts run one epoch on the CPU, narrowed.
"""

import argparse
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

import tgm_tpu_torch.nn.modules.mlp_mixer as p_mixer
from examples._datasets import load_dataset as j_load_dataset
from examples._linkpred_common import run_epochs as j_run_epochs
from examples._linkpred_common import setup_linkpred as j_setup_linkpred
from tgm_tpu import DGDataLoader as JLoader
from tgm_tpu import DGraph as JDGraph
from tgm_tpu.constants import PADDED_NODE_ID
from tgm_tpu.eval.metrics import mrr_sum_count as j_mrr_sum_count
from tgm_tpu.eval.metrics import ndcg_at_k as j_ndcg_at_k
from tgm_tpu.hooks import HookManager as JHookManager
from tgm_tpu.hooks import RecencyNeighborHook as JRecency
from tgm_tpu.hooks import candidate_rows as j_candidate_rows
from tgm_tpu.hooks import seed_lookup as j_seed_lookup
from tgm_tpu.nn import LinkPredictor as JLinkPredictor
from tgm_tpu.nn import NodePredictor as JNodePredictor
from tgm_tpu.nn import RandomProjectionModule as JRP
from tgm_tpu.nn import TPNet as JTPNet
from tgm_tpu.nn.encoder.tpnet import rp_update as j_rp_update
from tgm_tpu_torch.examples._datasets import load_dataset
from tgm_tpu_torch.examples.linkproppred import tpnet as tp_link
from tgm_tpu_torch.examples.nodeproppred import tpnet as tp_node
from tgm_tpu_torch.weights import load_tpnet_params, rp_state_from_numpy

DATASET, BSIZE, K, TIME, EMB = "synthetic-120-800", 96, 5, 8, 16
NODE_BSIZE, NODE_EDGE_DIM, C, NODE_LR = 16, 8, 4, 1e-4
EPOCHS, LR, SEED = 2, 1e-3, 1337


def link_args(**kw):
    base = dict(dataset=DATASET, seed=SEED, bsize=BSIZE, epochs=EPOCHS, lr=LR, dropout=0.0,
                n_nbrs=K, time_dim=TIME, embed_dim=EMB, rp_layers=2, rp_time_decay=1e-6,
                device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


def np_state(state):
    return [np.asarray(x) for x in state]


def bce(pos, neg, valid):
    m = valid.astype(pos.dtype)
    d = jnp.maximum(m.sum(), 1.0)
    return (jnp.sum(optax.sigmoid_binary_cross_entropy(pos, jnp.ones_like(pos)) * m)
            + jnp.sum(optax.sigmoid_binary_cross_entropy(neg, jnp.zeros_like(neg)) * m)) / d


def run_jax_link():
    """The JAX example's flow (examples/linkproppred/tpnet.py:29-183) at the
    test's sizes, dropout 0."""
    args = link_args(device=None)
    setup = j_setup_linkpred(args, static_dim=8)
    num_nodes, edge_dim, node_x = setup.num_nodes, setup.edge_dim, setup.node_x
    rec = JRecency(num_nodes, [K], ["edge_src", "edge_dst", "neg"],
                   ["edge_time", "edge_time", "neg_time"], edge_dim=edge_dim)
    setup.hm.register_shared(rec)
    rp = JRP(num_nodes=num_nodes, num_layer=2, time_decay_weight=1e-6,
             beginning_time=float(setup.train_dg.start_time or 0), use_matrix=False,
             enforce_dim=min(64, num_nodes))
    encoder = JTPNet(node_feat_dim=node_x.shape[1], edge_x_dim=edge_dim, time_feat_dim=TIME,
                     output_dim=EMB, num_neighbors=K, dropout=0.0, random_projections=rp)
    decoder = JLinkPredictor(node_dim=EMB, hidden_dim=EMB)
    opt = optax.adam(LR)
    key = jax.random.PRNGKey(SEED)
    key, k1, k2, k3 = jax.random.split(key, 4)
    rp_state = rp.init_state(k1)
    ez = lambda *s: jnp.zeros(s, jnp.int32)
    params = {"enc": encoder.init(k2, node_x, ez(4), ez(4), ez(4), ez(8, K), ez(8, K),
                                  jnp.zeros((8, K, edge_dim)), rp_state),
              "dec": decoder.init(k3, jnp.zeros((1, EMB)), jnp.zeros((1, EMB)))}
    init = dict(params=jax.tree_util.tree_map(np.asarray, params), rp0=np_state(rp_state))
    opt_state = opt.init(params)

    def rows(batch, a, b):
        B = batch.edge_src.shape[0]
        sel = lambda x: jnp.concatenate([x[a * B:(a + 1) * B], x[b * B:(b + 1) * B]])
        return sel(batch.nbr_nids[0]), sel(batch.nbr_edge_time[0]), sel(batch.nbr_edge_x[0])

    @partial(jax.jit, donate_argnums=(1,))
    def train_step(params, opt_state, rp_state, batch):
        def loss_fn(p):
            zs, zd = encoder.apply(p["enc"], node_x, batch.edge_src, batch.edge_dst,
                                   batch.edge_time, *rows(batch, 0, 1), rp_state)
            zs2, zn = encoder.apply(p["enc"], node_x, batch.edge_src, batch.neg, batch.edge_time,
                                    *rows(batch, 0, 2), rp_state)
            return bce(decoder.apply(p["dec"], zs, zd), decoder.apply(p["dec"], zs2, zn),
                       batch.edge_valid)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        rp_state = j_rp_update(rp_state, batch.edge_src, batch.edge_dst, batch.edge_time,
                               batch.edge_valid, 1e-6)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, rp_state, loss

    @jax.jit
    def eval_step(params, rp_state, batch):
        B = batch.edge_src.shape[0]
        Q = batch.neg_batch_list.shape[1]
        zs, zd = encoder.apply(params["enc"], node_x, batch.edge_src, batch.edge_dst,
                               batch.edge_time, *rows(batch, 0, 1), rp_state)
        pos = decoder.apply(params["dec"], zs, zd)
        negs = batch.neg_batch_list.reshape(-1)
        nbr, nt, nx = batch.nbr_nids[0], batch.nbr_edge_time[0], batch.nbr_edge_x[0]
        lut = j_seed_lookup(batch.seed_nids[0], node_x.shape[0])
        cand, found = j_candidate_rows(lut, negs, nbr.shape[0])
        rep = lambda x: jnp.repeat(x[:B], Q, axis=0)
        zs2, zn = encoder.apply(
            params["enc"], node_x, jnp.repeat(batch.edge_src, Q), negs,
            jnp.repeat(batch.edge_time, Q), jnp.concatenate([rep(nbr), nbr[cand]]),
            jnp.concatenate([rep(nt), nt[cand]]), jnp.concatenate([rep(nx), nx[cand]]), rp_state)
        neg = decoder.apply(params["dec"], zs2, zn).reshape(B, Q)
        s, c = j_mrr_sum_count(pos, neg, neg_valid=(batch.neg_batch_list != PADDED_NODE_ID)
                               & found.reshape(B, Q), edge_valid=batch.edge_valid)
        rp_state = j_rp_update(rp_state, batch.edge_src, batch.edge_dst, batch.edge_time,
                               batch.edge_valid, 1e-6)
        return rp_state, s, c

    st = {"params": params, "opt": opt_state, "rp": rp_state}
    out = {"losses": [[]], "epochs": [], "neg": [], "neg_time": []}

    def train_batch(batch):
        out["neg"].append(np.asarray(batch.neg))
        st["params"], st["opt"], st["rp"], loss = train_step(st["params"], st["opt"], st["rp"],
                                                             batch)
        out["losses"][-1].append(float(loss))
        return loss

    def eval_batch(batch):
        out["neg_time"].append(np.asarray(batch.neg_time))
        st["rp"], s, c = eval_step(st["params"], st["rp"], batch)
        st["sums"].append((float(s), float(c)))
        return s, c

    def epoch_end():  # after val, before the reset
        s, c = np.sum(st["sums"], axis=0)
        out["epochs"].append(dict(rp=np_state(st["rp"]), rec=[np.asarray(a) for a in rec.state],
                                  val=s / max(c, 1.0)))
        out["losses"].append([])

    reset = setup.hm.reset_state
    setup.hm.reset_state = lambda *a: (epoch_end(), reset(*a))

    def on_epoch_start():
        st["rp"] = rp.init_state(k1)

    def on_train_end():
        st["sums"] = []
        st["backup"] = JRP.backup_random_projections(st["rp"])
        out["backups"] = out.get("backups", []) + [np_state(st["rp"])]

    def on_test_start():
        epoch_end()
        st["rp"] = JRP.reload_random_projections(st["backup"])

    out["test"] = j_run_epochs(setup, args, train_batch, eval_batch, on_epoch_start,
                               on_train_end, on_test_start)
    out["losses"].pop()
    return init, out


def rp_close(got, want, what):
    proj = np.asarray(want[0])
    np.testing.assert_allclose(got.projections.numpy(), proj, rtol=0,
                               atol=1e-5 * float(np.abs(proj).max()), err_msg=what)
    np.testing.assert_allclose(float(got.now_time), float(want[1]), rtol=1e-7, err_msg=what)


def test_link_two_epochs_match_the_jax_example_flow():
    init, j = run_jax_link()
    a = link_args()
    ctx = tp_link.build(a)
    load_tpnet_params(init["params"], ctx.encoder, ctx.decoder)
    ctx.rp_state0 = rp_state_from_numpy(*init["rp0"])
    negs, neg_times = iter(j["neg"]), iter(j["neg_time"])
    hooks = ctx.setup.neg_hooks
    hooks["train"].draw_neg = lambda size: torch.from_numpy(next(negs).copy())
    for split in ("val", "test"):
        hooks[split].draw_neg_time = lambda n, lo, hi: torch.from_numpy(next(neg_times).copy())
    states, backups = [], []
    backup = ctx.rp.backup_random_projections
    ctx.rp.backup_random_projections = lambda s: backups.append(backup(s)) or backups[-1]
    p = tp_link.run(ctx, a, on_epoch_end=lambda e: states.append(
        (ctx.rp_state, [t.clone() for t in ctx.recency.state])))
    assert next(negs, None) is None and next(neg_times, None) is None

    loss_gap = [np.abs(np.subtract(x, y)) for x, y in zip(p["losses"], j["losses"])]
    j_val = [e["val"] for e in j["epochs"]]
    val_gap = max(abs(x - y) for x, y in zip(p["val_mrr"], j_val))
    test_gap = abs(p["test_mrr"] - j["test"])
    print(f"TPNet link: {sum(len(x) for x in j['losses'])} train batches, first-loss gap "
          f"{loss_gap[0][0]:.3g}, max loss gap {max(g.max() for g in loss_gap):.3g}; val MRR "
          f"{j_val} (gap {val_gap:.3g}), test MRR {j['test']:.6f} (gap {test_gap:.3g})")
    assert [len(x) for x in p["losses"]] == [len(x) for x in j["losses"]]
    assert len(p["losses"]) == EPOCHS and len(p["losses"][0]) >= 5
    assert loss_gap[0][0] <= 1e-5 and max(g.max() for g in loss_gap) <= 5e-3
    assert val_gap <= 0.01 and test_gap <= 0.02
    assert all(0.0 < v <= 1.0 for v in p["val_mrr"]) and 0.0 < p["test_mrr"] <= 1.0
    for e, ((rp_state, rec), jj) in enumerate(zip(states, j["epochs"])):
        rp_close(rp_state, jj["rp"], f"RP state after epoch {e}")
        for i, (x, y) in enumerate(zip(rec, jj["rec"])):
            np.testing.assert_array_equal(x.numpy(), y, err_msg=f"epoch {e} recency tensor {i}")
    for e, (x, y) in enumerate(zip(backups, j["backups"])):
        rp_close(x, y, f"RP backup of epoch {e}")
    # Fault 18: test starts from the backup taken after the last train split,
    # not from the state val left; the recency hook keeps val.
    assert not torch.equal(backups[-1].projections, states[-1][0].projections)
    assert float(ctx.rp_state.now_time) >= float(backups[-1].now_time)
    assert losses_learned(p["losses"])


def losses_learned(losses):
    flat = np.concatenate([np.asarray(x) for x in losses])
    return flat.max() - flat.min() > 1e-3


def node_args(**kw):
    base = dict(dataset=DATASET, seed=SEED, bsize=NODE_BSIZE, epochs=EPOCHS, lr=NODE_LR,
                dropout=0.0, n_nbrs=K, time_dim=TIME, embed_dim=EMB, num_classes=C, device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


def run_jax_node():
    """The JAX example's flow (examples/nodeproppred/tpnet.py:32-164) at the
    test's sizes, dropout 0; per epoch the per-batch losses, val NDCG, the RP
    and recency states after val; the test NDCG; the label-less batches."""
    data = j_load_dataset(DATASET, edge_dim=NODE_EDGE_DIM, node_label_classes=C)[0]
    rng = np.random.default_rng(SEED)
    data.static_node_x = rng.normal(size=(data.num_nodes, 8)).astype(np.float32)
    num_nodes = data.num_nodes
    node_x = jnp.asarray(data.static_node_x)
    dgs = [JDGraph(s) for s in data.split()]
    hm = JHookManager(keys=["all"])
    rec = JRecency(num_nodes, [K], ["node_y_nids"], ["node_y_time"], edge_dim=NODE_EDGE_DIM)
    hm.register_shared(rec)
    rp = JRP(num_nodes=num_nodes, num_layer=2, time_decay_weight=1e-6, use_matrix=False,
             enforce_dim=min(64, num_nodes))
    encoder = JTPNet(node_feat_dim=8, edge_x_dim=NODE_EDGE_DIM, time_feat_dim=TIME,
                     output_dim=EMB, num_neighbors=K, num_layers=1, dropout=0.0,
                     random_projections=rp)
    decoder = JNodePredictor(in_dim=EMB, out_dim=C)
    opt = optax.adam(NODE_LR)
    key = jax.random.PRNGKey(SEED)
    key, kr, k1, k2 = jax.random.split(key, 4)
    rp_state0 = rp.init_state(kr)

    def encode(p, rp_state, batch):
        nids, t = batch.node_y_nids, batch.node_y_time
        two = lambda x: jnp.concatenate([x, x])
        zs, _ = encoder.apply(p["enc"], node_x, nids, nids, t, two(batch.nbr_nids[0]),
                              two(batch.nbr_edge_time[0]), two(batch.nbr_edge_x[0]), rp_state)
        return decoder.apply(p["dec"], zs)

    with hm.activate("all"):
        b0 = next(b for b in JLoader(dgs[0], NODE_BSIZE, hook_manager=hm)
                  if b.node_y_nids is not None)
    hm.reset_state()
    two = lambda x: jnp.concatenate([x, x])
    params = {"enc": encoder.init(k1, node_x, b0.node_y_nids, b0.node_y_nids, b0.node_y_time,
                                  two(b0.nbr_nids[0]), two(b0.nbr_edge_time[0]),
                                  two(b0.nbr_edge_x[0]), rp_state0),
              "dec": decoder.init(k2, jnp.zeros((1, EMB)))}
    init = dict(params=jax.tree_util.tree_map(np.asarray, params), rp0=np_state(rp_state0))
    opt_state = opt.init(params)

    @jax.jit
    def train_step(params, opt_state, rp_state, batch):
        def loss_fn(p):
            loss = optax.softmax_cross_entropy(encode(p, rp_state, batch), batch.node_y)
            m = batch.node_y_valid.astype(loss.dtype)
            return jnp.sum(loss * m) / jnp.maximum(m.sum(), 1.0)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        rp_state = j_rp_update(rp_state, batch.edge_src, batch.edge_dst, batch.edge_time,
                               batch.edge_valid, 1e-6)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, rp_state, loss

    @jax.jit
    def eval_step(params, rp_state, batch):
        ndcg = j_ndcg_at_k(encode(params, rp_state, batch), batch.node_y, k=10,
                           row_valid=batch.node_y_valid)
        return j_rp_update(rp_state, batch.edge_src, batch.edge_dst, batch.edge_time,
                           batch.edge_valid, 1e-6), ndcg

    st = {"params": params, "opt": opt_state, "rp": rp_state0, "skipped": 0, "label_less": 0}

    def run(dg, train):
        out = []
        with hm.activate("all"):
            for batch in JLoader(dg, NODE_BSIZE, hook_manager=hm):
                if batch.node_y_nids is None:
                    st["skipped"] += 1
                    continue
                st["label_less"] += not bool(np.asarray(batch.node_y_valid).any())
                if train:
                    st["params"], st["opt"], st["rp"], loss = train_step(
                        st["params"], st["opt"], st["rp"], batch)
                    out.append(float(loss))
                else:
                    st["rp"], ndcg = eval_step(st["params"], st["rp"], batch)
                    out.append(float(ndcg))
        return out

    epochs = []
    for e in range(EPOCHS):
        st["rp"] = rp_state0
        losses = run(dgs[0], True)
        val = float(np.mean(run(dgs[1], False)))
        epochs.append(dict(losses=losses, val=val, rp=np_state(st["rp"]),
                           rec=[np.asarray(a) for a in rec.state]))
        if e < EPOCHS - 1:
            hm.reset_state()
    test = float(np.mean(run(dgs[-1], False)))
    return init, epochs, test, st["skipped"], st["label_less"]


def test_node_two_epochs_match_the_jax_example_flow():
    init, j_epochs, j_test, skipped, label_less = run_jax_node()
    # Fault 19: the loader pads a batch without labels (node_y_valid all
    # False) instead of leaving its label fields out, so the example's skip
    # never fires on a labelled stream: such a batch takes a train step
    # (zero loss) and an RP update, in both packages.
    assert skipped == 0 and label_less > 0
    a = node_args()
    ctx = tp_node.build(a, data=load_dataset(DATASET, edge_dim=NODE_EDGE_DIM,
                                             node_label_classes=C)[0])
    load_tpnet_params(init["params"], ctx.encoder, ctx.decoder)
    ctx.rp_state0 = rp_state_from_numpy(*init["rp0"])
    states = []
    p = tp_node.run(ctx, a, on_epoch_end=lambda e: states.append(
        (ctx.rp_state, [t.clone() for t in ctx.recency.state])))
    loss_gap = [np.abs(np.subtract(x, y["losses"])) for x, y in zip(p["losses"], j_epochs)]
    val_gap = max(abs(x - y["val"]) for x, y in zip(p["val_ndcg"], j_epochs))
    test_gap = abs(p["test_ndcg"] - j_test)
    print(f"TPNet node: {sum(len(x) for x in p['losses'])} train batches ({label_less} "
          f"loader batches without a label over the run, none skipped), first-loss gap "
          f"{loss_gap[0][0]:.3g}, max loss gap {max(g.max() for g in loss_gap):.3g}; val NDCG "
          f"{[e['val'] for e in j_epochs]} (gap {val_gap:.3g}), test NDCG {j_test:.6f} (gap "
          f"{test_gap:.3g})")
    assert [len(x) for x in p["losses"]] == [len(e["losses"]) for e in j_epochs]
    assert len(p["losses"][0]) >= 5
    assert loss_gap[0][0] <= 1e-5 and max(g.max() for g in loss_gap) <= 5e-3
    assert val_gap <= 0.01 and test_gap <= 0.02
    assert all(0.0 < v <= 1.0 for v in p["val_ndcg"]) and 0.0 < p["test_ndcg"] <= 1.0
    for e, ((rp_state, rec), jj) in enumerate(zip(states, j_epochs)):
        rp_close(rp_state, jj["rp"], f"RP state after epoch {e}")
        for i, (x, y) in enumerate(zip(rec, jj["rec"])):
            np.testing.assert_array_equal(x.numpy(), y, err_msg=f"epoch {e} recency tensor {i}")
    assert losses_learned(p["losses"])


def test_node_batches_without_labels_still_step():
    # Fault 19: a batch without labels comes padded, so the example's skip
    # does not fire: the RP state follows every batch, the loss of such a
    # batch is 0, and Adam's step still moves the weights (its momentum).
    a = node_args(epochs=1)
    ctx = tp_node.build(a, data=load_dataset(DATASET, edge_dim=NODE_EDGE_DIM,
                                             node_label_classes=C)[0])
    from tgm_tpu_torch.data import DGDataLoader
    from tgm_tpu_torch.nn import rp_update

    every, label_less = ctx.rp_state0, []
    for i, batch in enumerate(DGDataLoader(ctx.dgs[0], NODE_BSIZE, device="cpu")):
        assert batch.has("node_y_nids")
        every = rp_update(every, batch.edge_src, batch.edge_dst, batch.edge_time,
                          batch.edge_valid, 1e-6)
        if not bool(batch.node_y_valid.any()):
            label_less.append(i)
    assert label_less and label_less[0] > 0
    ctx.rp_state = ctx.rp_state0
    moved = []
    step = ctx.train_core

    def recording(carry, batch):
        w = ctx.decoder.model[0].weight.detach().clone()
        out = step(carry, batch)
        if not bool(batch.node_y_valid.any()):
            moved.append(not torch.equal(w, ctx.decoder.model[0].weight))
        return out

    ctx.train_core = recording
    losses = tp_node.run_split(ctx, a, 0, "train")
    assert losses.shape[0] == i + 1  # every loader batch took a step
    assert torch.all(losses[label_less] == 0) and torch.all(losses[0:1] > 0)
    assert len(moved) == len(label_less) and all(moved)
    assert torch.allclose(ctx.rp_state.projections, every.projections, rtol=0, atol=1e-6)


def test_paired_train_calls_draw_the_same_dropout_masks(monkeypatch):
    a = link_args(dropout=0.3)
    ctx = tp_link.build(a)
    masks = []
    plain = p_mixer.dropout

    def recording(x, p, generator, mask_shape=None):
        out = plain(x, p, generator, mask_shape)
        if generator is not None:
            masks.append(((out == 0) & (x != 0)).clone())
        return out

    monkeypatch.setattr(p_mixer, "dropout", recording)
    fn, states = ctx.hm.as_transform("train", ctx.setup.dgs["train"])
    carry = (ctx.generator, ctx.rp_state0)
    per_step = []
    for i in range(2):
        states, batch = fn(states, ctx.setup.streams["train"].batch_at(i))
        masks.clear()
        carry, loss = ctx.train_core(carry, batch)
        per_step.append(list(masks))
    for step in per_step:
        # Two mixers, two FFNs each, two dropouts each: 8 masks a call.
        assert len(step) == 16
        first, second = step[:8], step[8:]
        for x, y in zip(first, second):
            assert torch.equal(x, y)
        assert any(bool(m.any()) for m in first)
    # The next step draws other masks.
    assert not all(torch.equal(x, y) for x, y in zip(per_step[0][:8], per_step[1][:8]))


def test_example_scripts_run_one_epoch_on_the_cpu():
    out = tp_link.main(["--dataset", DATASET, "--device", "cpu", "--n-nbrs", "4",
                        "--time-dim", "4", "--embed-dim", "8"])
    assert np.isfinite(out["loss"][0]) and 0.0 < out["test_mrr"] <= 1.0
    out = tp_node.main(["--dataset", DATASET, "--device", "cpu", "--n-nbrs", "3",
                        "--time-dim", "4", "--embed-dim", "8", "--num-classes", "3"])
    assert np.isfinite(out["loss"][0]) and 0.0 < out["test_ndcg"] <= 1.0
