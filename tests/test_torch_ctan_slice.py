"""The CTAN slice as a whole: the example's flow in both packages.

Two epochs of train then val on the synthetic stream of 120 nodes and 800
edges (8-dim edge features, 20 TGB candidates per eval edge), split
70/15/15, batches of 96, the memory reset at each epoch's start and the
hook state between epochs, then test, as ``examples/linkproppred/ctan.py``
runs it: the shared feature-layout recency hook (K = 5), the shared
``DeduplicationHook`` over ``neg`` and ``nbr_nids``, static node features
``normal(N, 8)`` from the seed, the Δt normalisation from the train
stream, time / embed dims 8 / 16, one antisymmetric step, Adam at lr 1e-3.
Same weights (JAX's init, loaded by ``load_ctan_params``). The frameworks
draw different random numbers, so the port is fed each draw of the JAX
random-negative hook (``neg``) and TGB hook (``neg_time``).

Bands: per-batch losses within 5e-3 and the first within 1e-5; val MRR
within 0.01 per epoch, test MRR within 0.02; the recency state exact after
each epoch; the CTAN memory within 1e-5 and ``last_update`` exact after
every split. The measured gaps are printed. The port's example script runs
one epoch on the CPU, narrowed.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from examples._datasets import load_dataset as j_load_dataset
from tgm_tpu import DGDataLoader as JLoader
from tgm_tpu import DGraph as JDGraph
from tgm_tpu.constants import PADDED_NODE_ID
from tgm_tpu.eval.metrics import mrr_sum_count as j_mrr_sum_count
from tgm_tpu.hooks import DeduplicationHook as JDedup
from tgm_tpu.hooks import HookManager as JHookManager
from tgm_tpu.hooks import RandomNegativeEdgeSamplerHook as JRandomNeg
from tgm_tpu.hooks import RecencyNeighborHook as JRecency
from tgm_tpu.hooks import TGBNegativeEdgeSamplerHook as JTGB
from tgm_tpu.hooks import map_to_local
from tgm_tpu.nn import CTAN as JCTAN
from tgm_tpu.nn import LinkPredictor as JLinkPredictor
from tgm_tpu.nn.encoder.ctan import ctan_memory_init as j_mem_init
from tgm_tpu.nn.encoder.ctan import ctan_memory_update as j_mem_update
from tgm_tpu_torch.examples._datasets import load_dataset
from tgm_tpu_torch.examples._linkpred_common import run_epochs
from tgm_tpu_torch.examples.linkproppred import ctan
from tgm_tpu_torch.nn import CTANMemoryState
from tgm_tpu_torch.weights import load_ctan_params

DATASET, EDGE_DIM, BSIZE, K, TIME, EMB = "synthetic-120-800", 8, 96, 5, 8, 16
EPOCHS, LR, SEED = 2, 1e-3, 1337
SPLITS = ("train", "val", "test")


def args(**kw):
    base = dict(dataset=DATASET, seed=SEED, bsize=BSIZE, epochs=EPOCHS, lr=LR, dropout=0.0,
                n_nbrs=[K], time_dim=TIME, embed_dim=EMB, num_iters=1, device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


def bce(pos, neg, valid):
    m = valid.astype(pos.dtype)
    return (jnp.sum(optax.sigmoid_binary_cross_entropy(pos, jnp.ones_like(pos)) * m)
            + jnp.sum(optax.sigmoid_binary_cross_entropy(neg, jnp.zeros_like(neg)) * m)
            ) / jnp.maximum(m.sum(), 1.0)


def run_jax():
    """The JAX example's flow (examples/linkproppred/ctan.py:31-166) at the
    test's sizes; returns its init parameters, per-epoch losses, val MRR,
    recency state and the memory after each split, the test MRR and memory,
    and every negative draw."""
    data, val_cands, test_cands = j_load_dataset(DATASET, edge_dim=EDGE_DIM)
    rng = np.random.default_rng(SEED)
    data.static_node_x = rng.normal(size=(data.num_nodes, 8)).astype(np.float32)
    num_nodes = data.num_nodes
    node_x = jnp.asarray(data.static_node_x)
    dgs = dict(zip(SPLITS, (JDGraph(d) for d in data.split())))
    hm = JHookManager(keys=list(SPLITS))
    dst = dgs["train"].edge_dst
    hm.register("train", JRandomNeg(low=int(dst.min()), high=int(dst.max())))
    hm.register("val", JTGB(candidates=val_cands))
    hm.register("test", JTGB(candidates=test_cands))
    rec = JRecency(num_nodes, [K], ["edge_src", "edge_dst", "neg"],
                   ["edge_time", "edge_time", "neg_time"], edge_dim=EDGE_DIM)
    hm.register_shared(rec)
    hm.register_shared(JDedup(num_nodes, seed_nodes_keys=["neg", "nbr_nids"]))

    t = np.asarray(dgs["train"].edge_time, dtype=np.float64)
    dts = np.diff(t)
    encoder = JCTAN(edge_dim=EDGE_DIM, memory_dim=EMB, time_dim=TIME, node_dim=8, num_iters=1,
                    mean_delta_t=float(dts.mean()), std_delta_t=float(max(dts.std(), 1e-6)))
    decoder = JLinkPredictor(node_dim=EMB, hidden_dim=EMB)
    opt = optax.adam(LR)
    k1, k2 = jax.random.split(jax.random.PRNGKey(SEED))
    e4 = jnp.zeros(4, jnp.int32)
    params = {"enc": encoder.init(k1, jnp.zeros((8, EMB + 8)), jnp.zeros(8, jnp.int32), e4, e4,
                                  e4, jnp.zeros((4, EDGE_DIM)), jnp.ones(4, bool)),
              "dec": decoder.init(k2, jnp.zeros((1, EMB)), jnp.zeros((1, EMB)))}
    init_params = jax.tree_util.tree_map(np.asarray, params)
    opt_state = opt.init(params)

    def encode(p, mem_state, batch):
        g2l, uids = batch.global_to_local, batch.unique_nids
        rows = jnp.where(uids >= 0, uids, num_nodes)
        x = jnp.concatenate([mem_state.memory[rows],
                             node_x[jnp.maximum(uids, 0)] * (uids >= 0)[:, None]], axis=1)
        seeds, nbrs = batch.seed_nids[0], batch.nbr_nids[0]
        src_rep, nbr_flat = jnp.repeat(seeds, nbrs.shape[1]), nbrs.reshape(-1)
        e_valid = (nbr_flat != PADDED_NODE_ID) & (src_rep != PADDED_NODE_ID)
        return encoder.apply(p["enc"], x, mem_state.last_update[rows],
                             map_to_local(g2l, src_rep), map_to_local(g2l, nbr_flat),
                             batch.nbr_edge_time[0].reshape(-1),
                             batch.nbr_edge_x[0].reshape(nbr_flat.shape[0], -1), e_valid)

    @jax.jit
    def train_step(params, opt_state, mem_state, batch):
        g2l = batch.global_to_local

        def loss_fn(p):
            z = encode(p, mem_state, batch)
            zs, zd, zn = (z[map_to_local(g2l, ids)]
                          for ids in (batch.edge_src, batch.edge_dst, batch.neg))
            pos = decoder.apply(p["dec"], zs, zd)
            neg = decoder.apply(p["dec"], zs, zn)
            return bce(pos, neg, batch.edge_valid), (zs, zd)

        (loss, (zs, zd)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        mem_state = j_mem_update(mem_state, batch.edge_src, batch.edge_dst, batch.edge_time,
                                 zs, zd, batch.edge_valid)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, mem_state, loss

    @jax.jit
    def eval_step(params, mem_state, batch):
        B, Q = batch.neg_batch_list.shape
        g2l = batch.global_to_local
        z = encode(params, mem_state, batch)
        zs, zd = z[map_to_local(g2l, batch.edge_src)], z[map_to_local(g2l, batch.edge_dst)]
        zn = z[map_to_local(g2l, batch.neg_batch_list.reshape(-1))]
        pos = decoder.apply(params["dec"], zs, zd)
        neg = decoder.apply(params["dec"], jnp.repeat(zs[:, None, :], Q, 1).reshape(B * Q, -1),
                            zn).reshape(B, Q)
        s, c = j_mrr_sum_count(pos, neg, neg_valid=batch.neg_batch_list != PADDED_NODE_ID,
                               edge_valid=batch.edge_valid)
        mem_state = j_mem_update(mem_state, batch.edge_src, batch.edge_dst, batch.edge_time,
                                 zs, zd, batch.edge_valid)
        return mem_state, s, c

    draws = {"neg": [], "neg_time": []}

    def batches(split):
        with hm.activate(split):
            for batch in JLoader(dgs[split], BSIZE, hook_manager=hm):
                draws["neg" if split == "train" else "neg_time"].append(
                    np.asarray(batch.neg if split == "train" else batch.neg_time))
                yield batch

    def mem_record(mem_state):
        return [np.asarray(mem_state.memory), np.asarray(mem_state.last_update)]

    def run_eval(split, mem_state):
        s = c = 0.0
        for batch in batches(split):
            mem_state, ds, dc = eval_step(params, mem_state, batch)
            s, c = s + float(ds), c + float(dc)
        return mem_state, s / max(c, 1.0)

    epochs = []
    for e in range(EPOCHS):
        mem_state = j_mem_init(num_nodes, EMB)
        losses = []
        for batch in batches("train"):
            params, opt_state, mem_state, loss = train_step(params, opt_state, mem_state, batch)
            losses.append(float(loss))
        after_train = mem_record(mem_state)
        mem_state, val = run_eval("val", mem_state)
        epochs.append(dict(losses=losses, val=val, rec=[np.asarray(a) for a in rec.state],
                           mem=[after_train, mem_record(mem_state)]))
        if e < EPOCHS - 1:
            hm.reset_state()
    mem_state, test = run_eval("test", mem_state)
    return init_params, epochs, test, mem_record(mem_state), draws


def assert_memory(label, got, want):
    np.testing.assert_allclose(got.memory.numpy(), want[0], rtol=0, atol=1e-5, err_msg=label)
    np.testing.assert_array_equal(got.last_update.numpy(), want[1], err_msg=label)
    return float(np.abs(got.memory.numpy() - want[0]).max())


def test_two_epochs_match_the_jax_example_flow():
    params, j_epochs, j_test, j_test_mem, draws = run_jax()
    a = args()
    data, val_cands, test_cands = load_dataset(DATASET, edge_dim=EDGE_DIM)
    ctx = ctan.build(a, data=data, cands=(val_cands, test_cands))
    load_ctan_params(params, ctx.encoder, ctx.decoder)
    negs, neg_times = iter(draws["neg"]), iter(draws["neg_time"])
    ctx.setup.neg_hooks["train"].draw_neg = lambda size: torch.from_numpy(next(negs).copy())
    for split in ("val", "test"):
        ctx.setup.neg_hooks[split].draw_neg_time = (
            lambda n, lo, hi: torch.from_numpy(next(neg_times).copy()))
    mems, rec_states = [], []

    def keep_memory():
        mems.append(CTANMemoryState(*(x.clone() for x in ctx.mem)))

    def on_epoch_end(e):
        keep_memory()
        rec_states.append([x.clone() for x in ctx.recency.state])

    # ``ctan.run`` with a look at the memory after each train split.
    p_out = run_epochs(ctx.setup, a, ctan.batch_fn(ctx, "train"), ctan.batch_fn(ctx, "eval"),
                       on_train_end=keep_memory, on_epoch_end=on_epoch_end, **ctan.hooks(ctx))
    assert next(negs, None) is None and next(neg_times, None) is None

    mem_gap = 0.0
    for e, j in enumerate(j_epochs):
        for split, got, want in zip(("train", "val"), mems[2 * e : 2 * e + 2], j["mem"]):
            mem_gap = max(mem_gap, assert_memory(f"epoch {e} after {split}", got, want))
    mem_gap = max(mem_gap, assert_memory("after test", ctx.mem, j_test_mem))
    loss_gap = [np.abs(np.subtract(p, j["losses"])) for p, j in zip(p_out["losses"], j_epochs)]
    val_gap = max(abs(p - j["val"]) for p, j in zip(p_out["val_mrr"], j_epochs))
    test_gap = abs(p_out["test_mrr"] - j_test)
    losses = np.concatenate([j["losses"] for j in j_epochs])
    print(f"CTAN: {losses.size} train batches, first-loss gap {loss_gap[0][0]:.3g}, max loss gap "
          f"{max(g.max() for g in loss_gap):.3g}; val MRR {[j['val'] for j in j_epochs]} (gap "
          f"{val_gap:.3g}), test MRR {j_test:.6f} (gap {test_gap:.3g}); memory gap {mem_gap:.3g}")
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
    assert float(ctx.mem.memory.abs().max()) > 0  # the store was written


def test_example_script_runs_one_epoch_on_the_cpu():
    out = ctan.main(["--dataset", DATASET, "--device", "cpu", "--n-nbrs", "4", "--time-dim", "4",
                     "--embed-dim", "8", "--num-iters", "2"])
    assert np.isfinite(out["loss"][0]) and 0.0 < out["test_mrr"] <= 1.0
    assert len(out["losses"][0]) == 3  # ceil(560 train edges / 200)
