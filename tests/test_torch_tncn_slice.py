"""The TNCN slice as a whole: the example's flow in both packages.

Train then val on the synthetic stream of 120 nodes and 800 edges (8-dim
edge features, 20 TGB candidates per eval edge), split 70/15/15, batches
of 96, then test, as ``examples/linkproppred/tncn.py`` runs it: the
shared feature-layout recency hook (K = 5), the shared
``DeduplicationHook`` over ``neg`` and ``nbr_nids``, the TGN memory staged
over the batch's unique nodes, the segment ``GraphAttentionEmbedding``
and ``NCNPredictor``; train computes the loss and its gradients, commits
(flush, then store) with the parameters before the step, then steps Adam;
``flush_all`` ends training; eval scores, then stores, then flushes; the
memory resets at each epoch's start and the hooks between epochs. Memory
/ time / embed dims 16 / 8 / 16, dropout 0, Adam at lr 1e-3, same weights
(JAX's init, loaded by ``load_tncn_params``). The port is fed each draw of
the JAX random-negative hook (``neg``) and TGB hook (``neg_time``).

Two epochs at k = 2 and one at k = 4; the JAX example's eval builds the
adjacency rows in its blocked form, the port's in its one form. Bands:
per-batch losses within 5e-3 and the first within 1e-5; val MRR within
0.01 per epoch, test MRR within 0.02; the recency state and the memory's
integer fields exact after each epoch and after test, its memory rows
within 1e-4. The measured gaps are printed. The port's example script
runs one epoch on the CPU, narrowed, at k = 2, 4 and 8.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
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
from tgm_tpu.hooks import candidate_rows, map_to_local, seed_lookup
from tgm_tpu.nn import NCNPredictor as JNCN
from tgm_tpu.nn.decoder.ncnpred import ncn_adjacency_rows, ncn_adjacency_rows_blocked
from tgm_tpu.nn.encoder.tgn import GraphAttentionEmbedding as JAttn
from tgm_tpu.nn.encoder.tgn import TGNMemory as JMemory
from tgm_tpu.nn.encoder.tgn import tgn_store_messages as j_store
from tgm_tpu_torch.examples._datasets import load_dataset
from tgm_tpu_torch.examples.linkproppred import tncn
from tgm_tpu_torch.weights import load_tncn_params

DATASET, EDGE_DIM, BSIZE, K, MEM, TIME, EMB = "synthetic-120-800", 8, 96, 5, 16, 8, 16
LR, SEED = 1e-3, 1337
SPLITS = ("train", "val", "test")
INT_FIELDS = ("last_update", "s_other", "s_t", "s_valid", "d_other", "d_t", "d_valid")


def args(ncn_k, epochs, **kw):
    base = dict(dataset=DATASET, seed=SEED, bsize=BSIZE, epochs=epochs, lr=LR, dropout=0.0,
                n_nbrs=[K], time_dim=TIME, embed_dim=EMB, memory_dim=MEM, ncn_k=ncn_k,
                cn_time_decay=False, device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


def bce(pos, neg, valid):
    m = valid.astype(pos.dtype)
    return (jnp.sum(optax.sigmoid_binary_cross_entropy(pos, jnp.ones_like(pos)) * m)
            + jnp.sum(optax.sigmoid_binary_cross_entropy(neg, jnp.zeros_like(neg)) * m)
            ) / jnp.maximum(m.sum(), 1.0)


def run_jax(ncn_k, epochs):
    """The JAX example's flow (examples/linkproppred/tncn.py:42-300) at the
    test's sizes, table mode; returns its init parameters, per-epoch losses, val
    MRR, recency and memory state, the test MRR and memory, and every
    negative draw."""
    data, val_cands, test_cands = j_load_dataset(DATASET, edge_dim=EDGE_DIM)
    rng = np.random.default_rng(SEED)
    data.static_node_x = rng.normal(size=(data.num_nodes, 1)).astype(np.float32)
    num_nodes = data.num_nodes
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

    memory = JMemory(num_nodes=num_nodes, raw_msg_dim=EDGE_DIM, memory_dim=MEM, time_dim=TIME)
    encoder = JAttn(in_channels=MEM, out_channels=EMB, msg_dim=EDGE_DIM, time_dim=TIME,
                    dropout=0.0)
    decoder = JNCN(in_channels=EMB, hidden_dim=EMB, out_channels=1, k=ncn_k)
    opt = optax.adam(LR)
    mem_state = memory.init_state()
    _, k1, k2, k3 = jax.random.split(jax.random.PRNGKey(SEED), 4)
    e4 = jnp.zeros(4, jnp.int32)
    params = {
        "mem": memory.init(k1, mem_state, jnp.zeros(4, jnp.int32)),
        "enc": encoder.init(k2, jnp.zeros((8, MEM)), jnp.zeros(8, jnp.int32), e4, e4, e4,
                            jnp.zeros((4, EDGE_DIM)), jnp.ones(4, bool)),
        "dec": decoder.init(k3, jnp.zeros((8, EMB)), e4, e4, jnp.zeros(2, jnp.int32),
                            jnp.zeros(2, jnp.int32), jnp.zeros(8, jnp.int32),
                            jnp.zeros(2, jnp.int32)),
    }
    init_params = jax.tree_util.tree_map(np.asarray, params)
    opt_state = opt.init(params)

    def nbr_ok(batch):
        return ((batch.nbr_nids[0] != PADDED_NODE_ID)
                & (batch.seed_nids[0][:, None] != PADDED_NODE_ID))

    def encode(p, mem_state, batch, is_eval=False):
        g2l = batch.global_to_local
        z_mem, last_upd = memory.apply(p["mem"], mem_state, batch.unique_nids,
                                       method=JMemory.stage)
        seeds, nbrs = batch.seed_nids[0], batch.nbr_nids[0]
        src_rep, nbr_flat = jnp.repeat(seeds, nbrs.shape[1]), nbrs.reshape(-1)
        e_valid = (nbr_flat != PADDED_NODE_ID) & (src_rep != PADDED_NODE_ID)
        z = encoder.apply(p["enc"], z_mem, last_upd, map_to_local(g2l, src_rep),
                          map_to_local(g2l, nbr_flat), batch.nbr_edge_time[0].reshape(-1),
                          batch.nbr_edge_x[0].reshape(nbr_flat.shape[0], -1), e_valid)
        seeds_l, nbrs_l = map_to_local(g2l, seeds), map_to_local(g2l, nbrs)
        if is_eval:
            rows = ncn_adjacency_rows_blocked(seeds_l, nbrs_l, nbr_ok(batch), z.shape[0],
                                              unique_from=2 * batch.edge_src.shape[0])
        else:
            rows = ncn_adjacency_rows(seeds_l, nbrs_l, nbr_ok(batch), z.shape[0])
        return z, last_upd, rows

    def score(p, z, g2l, src, dst, last_upd, t, rows_i, rows_j):
        return decoder.apply(p["dec"], z, rows_i, rows_j, map_to_local(g2l, src),
                             map_to_local(g2l, dst), last_update=last_upd, edge_time=t,
                             method=JNCN.score_from_rows)

    def batch_nodes(batch):
        return jnp.where(jnp.concatenate([batch.edge_valid, batch.edge_valid]),
                         jnp.concatenate([batch.edge_src, batch.edge_dst]), num_nodes)

    @jax.jit
    def train_step(params, opt_state, mem_state, batch):
        B = batch.edge_src.shape[0]

        def loss_fn(p):
            z, last_upd, rows = encode(p, mem_state, batch)
            g2l = batch.global_to_local
            pos = score(p, z, g2l, batch.edge_src, batch.edge_dst, last_upd, batch.edge_time,
                        rows[:B], rows[B:2 * B])
            neg = score(p, z, g2l, batch.edge_src, batch.neg, last_upd, batch.edge_time,
                        rows[:B], rows[2 * B:])
            return bce(pos, neg, batch.edge_valid)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        mem_state = memory.apply(params["mem"], mem_state, batch_nodes(batch),
                                 method=JMemory.flush)
        mem_state = j_store(mem_state, batch.edge_src, batch.edge_dst, batch.edge_time,
                            batch.edge_x, batch.edge_valid)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, mem_state, loss

    @jax.jit
    def eval_step(params, mem_state, batch):
        B, Q = batch.neg_batch_list.shape
        g2l = batch.global_to_local
        z, last_upd, rows = encode(params, mem_state, batch, is_eval=True)
        negs = batch.neg_batch_list.reshape(-1)
        lut = seed_lookup(batch.seed_nids[0], num_nodes)
        cand_r, found = candidate_rows(lut, negs, rows.shape[0])
        pos = score(params, z, g2l, batch.edge_src, batch.edge_dst, last_upd, batch.edge_time,
                    rows[:B], rows[B:2 * B])
        neg = score(params, z, g2l, jnp.repeat(batch.edge_src, Q), negs, last_upd,
                    jnp.repeat(batch.edge_time, Q), jnp.repeat(rows[:B], Q, axis=0),
                    rows[cand_r]).reshape(B, Q)
        neg_valid = (batch.neg_batch_list != PADDED_NODE_ID) & found.reshape(B, Q)
        s, c = j_mrr_sum_count(pos, neg, neg_valid=neg_valid, edge_valid=batch.edge_valid)
        mem_state = j_store(mem_state, batch.edge_src, batch.edge_dst, batch.edge_time,
                            batch.edge_x, batch.edge_valid)
        mem_state = memory.apply(params["mem"], mem_state, batch_nodes(batch),
                                 method=JMemory.flush)
        return mem_state, s, c

    flush_all = jax.jit(lambda p, s: memory.apply(p["mem"], s, method=JMemory.flush_all))
    draws = {"neg": [], "neg_time": []}

    def batches(split):
        with hm.activate(split):
            for batch in JLoader(dgs[split], BSIZE, hook_manager=hm):
                draws["neg" if split == "train" else "neg_time"].append(
                    np.asarray(batch.neg if split == "train" else batch.neg_time))
                yield batch

    def run_eval(split, mem_state):
        s = c = 0.0
        for batch in batches(split):
            mem_state, ds, dc = eval_step(params, mem_state, batch)
            s, c = s + float(ds), c + float(dc)
        return mem_state, s / max(c, 1.0)

    def mem_record(state):
        return {k: np.asarray(v) for k, v in state._asdict().items()}

    out = []
    for e in range(epochs):
        mem_state = memory.init_state()
        losses = []
        for batch in batches("train"):
            params, opt_state, mem_state, loss = train_step(params, opt_state, mem_state, batch)
            losses.append(float(loss))
        mem_state = flush_all(params, mem_state)
        mem_state, val = run_eval("val", mem_state)
        out.append(dict(losses=losses, val=val, rec=[np.asarray(a) for a in rec.state],
                        mem=mem_record(mem_state)))
        if e < epochs - 1:
            hm.reset_state()
    mem_state, test = run_eval("test", mem_state)
    return init_params, out, test, mem_record(mem_state), draws


def assert_memory(label, got, want):
    for name in INT_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(), want[name],
                                      err_msg=f"{label}: {name}")
    gap = 0.0
    for name in ("mem", "s_raw", "d_raw"):
        x = getattr(got, name).numpy()
        np.testing.assert_allclose(x, want[name], rtol=0, atol=1e-4, err_msg=f"{label}: {name}")
        gap = max(gap, float(np.abs(x - want[name]).max()))
    return gap


@pytest.mark.parametrize("ncn_k,epochs", [(2, 2), (4, 1)])
def test_epochs_match_the_jax_example_flow(ncn_k, epochs):
    params, j_epochs, j_test, j_test_mem, draws = run_jax(ncn_k, epochs)
    a = args(ncn_k, epochs)
    data, val_cands, test_cands = load_dataset(DATASET, edge_dim=EDGE_DIM)
    ctx = tncn.build(a, data=data, cands=(val_cands, test_cands))
    load_tncn_params(params, ctx.memory, ctx.encoder, ctx.decoder)
    negs, neg_times = iter(draws["neg"]), iter(draws["neg_time"])
    ctx.setup.neg_hooks["train"].draw_neg = lambda size: torch.from_numpy(next(negs).copy())
    for split in ("val", "test"):
        ctx.setup.neg_hooks[split].draw_neg_time = (
            lambda n, lo, hi: torch.from_numpy(next(neg_times).copy()))
    mems, rec_states = [], []

    def on_epoch_end(e):
        mems.append(type(ctx.mem)(*(x.clone() for x in ctx.mem)))
        rec_states.append([x.clone() for x in ctx.recency.state])

    p_out = tncn.run(ctx, a, on_epoch_end=on_epoch_end)
    assert next(negs, None) is None and next(neg_times, None) is None

    mem_gap = max(assert_memory(f"epoch {e}", got, j["mem"])
                  for e, (got, j) in enumerate(zip(mems, j_epochs)))
    mem_gap = max(mem_gap, assert_memory("after test", ctx.mem, j_test_mem))
    loss_gap = [np.abs(np.subtract(p, j["losses"])) for p, j in zip(p_out["losses"], j_epochs)]
    val_gap = max(abs(p - j["val"]) for p, j in zip(p_out["val_mrr"], j_epochs))
    test_gap = abs(p_out["test_mrr"] - j_test)
    losses = np.concatenate([j["losses"] for j in j_epochs])
    print(f"TNCN k={ncn_k}: {losses.size} train batches, first-loss gap {loss_gap[0][0]:.3g}, "
          f"max loss gap {max(g.max() for g in loss_gap):.3g}; val MRR "
          f"{[j['val'] for j in j_epochs]} (gap {val_gap:.3g}), test MRR {j_test:.6f} (gap "
          f"{test_gap:.3g}); memory gap {mem_gap:.3g}")
    assert losses.size == epochs * len(j_epochs[0]["losses"]) and len(j_epochs[0]["losses"]) >= 5
    assert loss_gap[0][0] <= 1e-5
    assert max(g.max() for g in loss_gap) <= 5e-3
    assert val_gap <= 0.01 and test_gap <= 0.02
    for e, (p, j) in enumerate(zip(rec_states, j_epochs)):
        for i, (x, y) in enumerate(zip(p, j["rec"])):
            np.testing.assert_array_equal(x.numpy(), y, err_msg=f"epoch {e} recency tensor {i}")
    assert all(0.0 < v <= 1.0 for v in p_out["val_mrr"]) and 0.0 < p_out["test_mrr"] <= 1.0


@pytest.mark.parametrize("extra", [[], ["--ncn-k", "4"], ["--ncn-k", "8", "--cn-time-decay"]])
def test_example_script_runs_one_epoch_on_the_cpu(extra):
    out = tncn.main(["--dataset", DATASET, "--device", "cpu", "--n-nbrs", "4", "--time-dim", "4",
                     "--embed-dim", "8", "--memory-dim", "8", *extra])
    assert np.isfinite(out["loss"][0]) and 0.0 < out["test_mrr"] <= 1.0
    assert len(out["losses"][0]) == 3  # ceil(560 train edges / 200)
