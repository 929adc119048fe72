"""The node-property slice as a whole: the TGN and TGAT node examples' flows
in both packages.

Stream: the synthetic dataset of 120 nodes and 800 edges with 4 label
classes (a label every 20th edge) and 8-dim edge features, split 70/15/15;
batches of 60 events (``batch_unit="r"``), K = 5 recency neighbours, dims
16 (memory, embed) and 8 (time), Adam at lr 1e-3, two epochs then test.
Same weights in both packages (JAX's init, loaded by ``load_tgn_params`` /
``load_tgat_params``).

* TGN: the JAX example's flow (``examples/nodeproppred/tgn.py``: memory
  re-initialised per epoch, train, val, the hooks reset between epochs,
  test) against the port's example (``build`` + ``run``), through the
  scanned route (``DeviceEventStream`` + ``scanned_hook_epoch``) and
  ``--eager`` (the loader) in both packages.
* TGAT: the JAX example's flow (``examples/nodeproppred/tgat.py``: dropout
  0.1, the hooks reset after each epoch, train and val streamed through
  the hooks again before test) against the port's example. The JAX
  dropout masks are recorded as JAX draws them and fed to the port's
  dropout in the same order (ROADMAP.md fault 5).

Bands: the first loss within 1e-5, every per-batch loss within 5e-3, val
NDCG within 0.01 per epoch, test NDCG within 0.02. The gaps are printed.
"""

import argparse
from functools import lru_cache

import flax.linen as fnn
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
from tgm_tpu.eval.metrics import ndcg_at_k as j_ndcg_at_k
from tgm_tpu.hooks import DeduplicationHook as JDedup
from tgm_tpu.hooks import HookManager as JHookManager
from tgm_tpu.hooks import RecencyNeighborHook as JRecency
from tgm_tpu.hooks import map_to_local as j_map_to_local
from tgm_tpu.nn import TGAT as JTGAT
from tgm_tpu.nn import NodePredictor as JNodePredictor
from tgm_tpu.nn.encoder.tgn import GraphAttentionEmbedding as JGAE
from tgm_tpu.nn.encoder.tgn import TGNMemory as JMemory
from tgm_tpu.nn.encoder.tgn import tgn_store_messages as j_tgn_store_messages
from tgm_tpu.train import DeviceEventStream as JEventStream
from tgm_tpu.train import scanned_hook_epoch as j_scanned_hook_epoch
from tgm_tpu_torch.examples._datasets import load_dataset
from tgm_tpu_torch.examples.nodeproppred import tgat as tgat_np
from tgm_tpu_torch.examples.nodeproppred import tgn as tgn_np
from tgm_tpu_torch.nn.modules import attention as port_attention
from tgm_tpu_torch.weights import load_tgat_params, load_tgn_params

DATASET, C, EDGE_DIM, BSIZE, K, MEM, TIME, EMB = "synthetic-120-800", 4, 8, 60, 5, 16, 8, 16
EPOCHS, LR, SEED, DROPOUT = 2, 1e-3, 1337, 0.1


def args(**kw):
    base = dict(dataset=DATASET, seed=SEED, bsize=BSIZE, epochs=EPOCHS, lr=LR, n_nbrs=[K],
                time_dim=TIME, embed_dim=EMB, memory_dim=MEM, num_classes=C, eager=False,
                dropout=DROPOUT, device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


def j_data():
    return j_load_dataset(DATASET, edge_dim=EDGE_DIM, node_label_classes=C)[0]


def p_data():
    return load_dataset(DATASET, edge_dim=EDGE_DIM, node_label_classes=C)[0]


def compare(p, j, what):
    """Bands of the slice; prints the gaps."""
    p_losses = np.concatenate([np.asarray(x, np.float64) for x in p["losses"]])
    j_losses = np.concatenate([np.asarray(x, np.float64) for x in j["losses"]])
    assert p_losses.shape == j_losses.shape and p_losses.size >= 2 * 5
    gap = np.abs(p_losses - j_losses)
    val_gap = max(abs(a - b) for a, b in zip(p["val_ndcg"], j["val_ndcg"]))
    test_gap = abs(p["test_ndcg"] - j["test_ndcg"])
    print(f"{what}: {p_losses.size} train batches, first-loss gap {gap[0]:.3g}, max loss gap "
          f"{gap.max():.3g}; val NDCG {j['val_ndcg']} (gap {val_gap:.3g}), test NDCG "
          f"{j['test_ndcg']:.6f} (gap {test_gap:.3g})")
    assert gap[0] <= 1e-5
    assert gap.max() <= 5e-3
    assert val_gap <= 0.01 and test_gap <= 0.02
    assert all(0.0 < v <= 1.0 for v in p["val_ndcg"]) and 0.0 < p["test_ndcg"] <= 1.0
    assert j_losses.max() - j_losses.min() > 1e-3  # the runs learned something


# ---------------------------------------------------------------------- #
# TGN
# ---------------------------------------------------------------------- #
def j_tgn_modules(num_nodes):
    return (JMemory(num_nodes=num_nodes, raw_msg_dim=EDGE_DIM, memory_dim=MEM, time_dim=TIME),
            JGAE(in_channels=MEM, out_channels=EMB, msg_dim=EDGE_DIM, time_dim=TIME),
            JNodePredictor(in_dim=EMB, out_dim=C))


@lru_cache(maxsize=None)
def j_tgn_init_params(num_nodes):
    """The JAX initial parameters both routes and both packages start from,
    as numpy arrays (one compiled init, shared by the test's cases)."""
    memory, encoder, decoder = j_tgn_modules(num_nodes)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(SEED), 3)
    e4 = jnp.zeros(4, jnp.int32)
    params = jax.jit(lambda: {
        "mem": memory.init(k1, memory.init_state(), e4),
        "enc": encoder.init(k2, jnp.zeros((8, MEM)), jnp.zeros(8, jnp.int32), e4, e4, e4,
                            jnp.zeros((4, EDGE_DIM)), jnp.ones(4, bool)),
        "dec": decoder.init(k3, jnp.zeros((1, EMB)))})()
    return jax.tree_util.tree_map(np.array, params)


@lru_cache(maxsize=None)
def run_jax_tgn(eager: bool):
    """The JAX example's flow (examples/nodeproppred/tgn.py:57-205) at the
    test's sizes; returns the JAX parameters it started from and its
    per-batch losses, val and test NDCG."""
    data = j_data()
    num_nodes = data.num_nodes
    dgs = [JDGraph(s) for s in data.split()]
    hm = JHookManager(keys=["all"])
    hm.register_shared(JRecency(num_nodes, [K], ["node_y_nids"], ["node_y_time"],
                                edge_dim=EDGE_DIM))
    hm.register_shared(JDedup(num_nodes, seed_nodes_keys=["nbr_nids"]))
    memory, encoder, decoder = j_tgn_modules(num_nodes)
    opt = optax.adam(LR)
    init_params = j_tgn_init_params(num_nodes)
    params = jax.tree_util.tree_map(jnp.array, init_params)  # a copy: the scanned epoch donates

    def encode(p, mem_state, batch):
        z_mem, last_upd = memory.apply(p["mem"], mem_state, batch.unique_nids,
                                       method=JMemory.stage)
        g2l = batch.global_to_local
        seeds, nbrs = batch.seed_nids[0], batch.nbr_nids[0]
        src_rep = jnp.repeat(seeds, nbrs.shape[1])
        nbr_flat = nbrs.reshape(-1)
        e_valid = (nbr_flat != PADDED_NODE_ID) & (src_rep != PADDED_NODE_ID)
        z = encoder.apply(p["enc"], z_mem, last_upd, j_map_to_local(g2l, src_rep),
                          j_map_to_local(g2l, nbr_flat), batch.nbr_edge_time[0].reshape(-1),
                          batch.nbr_edge_x[0].reshape(nbr_flat.shape[0], -1), e_valid)
        return decoder.apply(p["dec"], z[j_map_to_local(g2l, batch.node_y_nids)])

    def commit(p, mem_state, batch):
        nodes = jnp.concatenate([batch.edge_src, batch.edge_dst])
        nodes = jnp.where(jnp.concatenate([batch.edge_valid, batch.edge_valid]), nodes,
                          num_nodes)
        mem_state = memory.apply(p["mem"], mem_state, nodes, method=JMemory.flush)
        return j_tgn_store_messages(mem_state, batch.edge_src, batch.edge_dst, batch.edge_time,
                                    batch.edge_x, batch.edge_valid)

    def train_core(carry, batch):
        params, opt_state, mem_state = carry
        has = jnp.any(batch.node_y_valid)

        def loss_fn(p):
            loss = optax.softmax_cross_entropy(encode(p, mem_state, batch), batch.node_y)
            m = batch.node_y_valid.astype(loss.dtype)
            return jnp.sum(loss * m) / jnp.maximum(m.sum(), 1.0)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        mem_state = commit(params, mem_state, batch)
        updates, opt_state2 = opt.update(grads, opt_state)
        params2 = optax.apply_updates(params, updates)
        keep = lambda new, old: jax.tree_util.tree_map(lambda a, b: jnp.where(has, a, b),
                                                       new, old)
        return (keep(params2, params), keep(opt_state2, opt_state), mem_state), (
            jnp.where(has, loss, 0.0), has)

    def eval_core(carry, batch):
        params, mem_state = carry
        has = jnp.any(batch.node_y_valid)
        ndcg = j_ndcg_at_k(encode(params, mem_state, batch), batch.node_y, k=10,
                           row_valid=batch.node_y_valid)
        return (params, commit(params, mem_state, batch)), (jnp.where(has, ndcg, 0.0), has)

    train_step, eval_step = jax.jit(train_core), jax.jit(eval_core)
    state = {"params": params, "opt": opt.init(params), "mem": memory.init_state()}
    epoch_fns = {}

    def run(dg, train):
        """Per-batch values and labelled flags of one split."""
        if eager:
            vals, has = [], []
            with hm.activate("all"):
                for batch in JLoader(dg, BSIZE, hook_manager=hm):
                    if train:
                        (state["params"], state["opt"], state["mem"]), (v, h) = train_step(
                            (state["params"], state["opt"], state["mem"]), batch)
                    else:
                        (state["params"], state["mem"]), (v, h) = eval_step(
                            (state["params"], state["mem"]), batch)
                    vals.append(float(v))
                    has.append(bool(h))
            return np.array(vals), np.array(has)
        key = (train, id(dg))
        if key not in epoch_fns:
            stream = JEventStream(JLoader(dg, BSIZE, hook_manager=hm))
            epoch_fns[key] = j_scanned_hook_epoch(stream, hm, "all", dg,
                                                  train_core if train else eval_core)[0]
        _, hstates = hm.as_transform("all", dg)
        if train:
            carry, hstates, (vals, has) = epoch_fns[key](
                (state["params"], state["opt"], state["mem"]), hstates)
            state["params"], state["opt"], state["mem"] = carry
        else:
            carry, hstates, (vals, has) = epoch_fns[key]((state["params"], state["mem"]),
                                                         hstates)
            state["params"], state["mem"] = carry
        hm.adopt_states("all", hstates)
        return np.asarray(vals), np.asarray(has)

    mean = lambda v, h: float(v[h].mean()) if h.any() else 0.0
    out = {"losses": [], "val_ndcg": []}
    for e in range(EPOCHS):
        state["mem"] = memory.init_state()
        vals, has = run(dgs[0], True)
        out["losses"].append(vals[has])
        out["val_ndcg"].append(mean(*run(dgs[1], False)))
        if e < EPOCHS - 1:
            hm.reset_state()
    out["test_ndcg"] = mean(*run(dgs[-1], False))
    return init_params, out


@pytest.mark.parametrize("eager", [False, True], ids=["scanned", "eager"])
def test_tgn_example_flow_matches_jax(eager):
    params, j_out = run_jax_tgn(eager)
    a = args(eager=eager)
    ctx = tgn_np.build(a, data=p_data())
    load_tgn_params(params, ctx.memory, ctx.encoder, ctx.decoder)
    p_out = tgn_np.run(ctx, a)
    p_out["losses"] = [np.asarray(v)[np.asarray(h)] for v, h in zip(p_out["losses"],
                                                                    p_out["has"])]
    compare(p_out, j_out, f"TGN {'eager' if eager else 'scanned'}")


def test_tgn_example_script_runs_both_routes_on_the_cpu():
    common = ["--dataset", "synthetic-120-800", "--device", "cpu", "--num-classes", "3",
              "--memory-dim", "8", "--time-dim", "4", "--embed-dim", "8", "--n-nbrs", "3"]
    scanned, eager = tgn_np.main(common), tgn_np.main(common + ["--eager"])
    # The same batches in the same order: equal up to the CPU's threaded
    # scatter-add sums (the segment route's gradients vary in the last bits).
    assert scanned["loss"] == pytest.approx(eager["loss"], abs=1e-5)
    assert scanned["test_ndcg"] == pytest.approx(eager["test_ndcg"], abs=1e-5)
    assert 0.0 < scanned["test_ndcg"] <= 1.0 and np.isfinite(scanned["loss"][0])
    # The scanned route keeps every planned batch, labelled or not.
    assert len(scanned["has"][0]) >= len(eager["has"][0])


# ---------------------------------------------------------------------- #
# TGAT, with the JAX dropout masks injected
# ---------------------------------------------------------------------- #
class RecordingDropout(fnn.Dropout):
    """flax ``nn.Dropout`` that also sows each mask it draws (same draws)."""

    @fnn.compact
    def __call__(self, inputs, deterministic=None, rng=None):
        deterministic = fnn.merge_param("deterministic", self.deterministic, deterministic)
        if self.rate == 0.0 or deterministic:
            return inputs
        keep = 1.0 - self.rate
        rng = self.make_rng(self.rng_collection) if rng is None else rng
        mask = jax.random.bernoulli(rng, p=keep, shape=inputs.shape)
        self.sow("intermediates", "mask", mask)
        return jax.lax.select(mask, inputs / keep, jnp.zeros_like(inputs))


def run_jax_tgat():
    """The JAX example's flow (examples/nodeproppred/tgat.py:46-150) at the
    test's sizes, recording each train step's dropout masks in call order."""
    data = j_data()
    rng = np.random.default_rng(SEED)
    data.static_node_x = rng.normal(size=(data.num_nodes, 8)).astype(np.float32)
    num_nodes = data.num_nodes
    node_x = jnp.asarray(data.static_node_x)
    dgs = [JDGraph(s) for s in data.split()]
    hm = JHookManager(keys=["all"])
    hm.register_shared(JRecency(num_nodes, [K], ["node_y_nids"], ["node_y_time"],
                                edge_dim=EDGE_DIM))
    encoder = JTGAT(node_dim=8, edge_dim=EDGE_DIM, time_dim=TIME, embed_dim=EMB, num_layers=1,
                    dropout=DROPOUT)
    decoder = JNodePredictor(in_dim=EMB, out_dim=C)
    opt = optax.adam(LR)
    k1, k2 = jax.random.split(jax.random.PRNGKey(SEED))
    hop = lambda *s: [jnp.zeros(s, jnp.int32)]
    params = jax.jit(lambda: {
        "enc": encoder.init(k1, node_x, hop(4), hop(4), hop(4, K),
                            [jnp.zeros((4, K, EDGE_DIM))], hop(4, K)),
        "dec": decoder.init(k2, jnp.zeros((1, EMB)))})()
    init_params, opt_state, key = params, opt.init(params), jax.random.PRNGKey(SEED)

    def logits(p, batch, rng=None):
        kw = {} if rng is None else dict(deterministic=False, rngs={"dropout": rng},
                                         mutable=["intermediates"])
        out = encoder.apply(p["enc"], node_x, batch.seed_nids, batch.seed_times,
                            batch.nbr_nids, batch.nbr_edge_x, batch.nbr_edge_time, **kw)
        z, inter = out if rng is not None else (out, None)
        return decoder.apply(p["dec"], z), inter

    @jax.jit
    def train_step(params, opt_state, rng, batch):
        rng, kd = jax.random.split(rng)

        def loss_fn(p):
            out, inter = logits(p, batch, kd)
            loss = optax.softmax_cross_entropy(out, batch.node_y)
            m = batch.node_y_valid.astype(loss.dtype)
            return jnp.sum(loss * m) / jnp.maximum(m.sum(), 1.0), inter

        (loss, inter), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = opt.update(grads, opt_state)
        masks = inter["intermediates"]["attn_0"]["drop"]["mask"]
        return optax.apply_updates(params, updates), opt_state, rng, loss, masks

    @jax.jit
    def eval_step(params, batch):
        return j_ndcg_at_k(logits(params, batch)[0], batch.node_y, k=10,
                           row_valid=batch.node_y_valid)

    masks = []

    def run(dg, train):
        nonlocal params, opt_state, key
        vals = []
        with hm.activate("all"):
            for batch in JLoader(dg, BSIZE, hook_manager=hm):
                if train:
                    params, opt_state, key, loss, m = train_step(params, opt_state, key, batch)
                    masks.extend(np.asarray(x) for x in m)
                    vals.append(float(loss))
                else:
                    vals.append(float(eval_step(params, batch)))
        return vals

    out = {"losses": [], "val_ndcg": []}
    for _ in range(EPOCHS):
        out["losses"].append(run(dgs[0], True))
        out["val_ndcg"].append(float(np.mean(run(dgs[1], False))))
        hm.reset_state()
    for dg in dgs[:-1]:
        with hm.activate("all"):
            for _ in JLoader(dg, BSIZE, hook_manager=hm):
                pass
    out["test_ndcg"] = float(np.mean(run(dgs[-1], False)))
    return init_params, np.asarray(data.static_node_x), masks, out


def test_tgat_example_flow_matches_jax_with_injected_dropout(monkeypatch):
    monkeypatch.setattr(fnn, "Dropout", RecordingDropout)
    params, node_x, masks, j_out = run_jax_tgat()
    assert len(masks) == 2 * sum(len(x) for x in j_out["losses"])  # two masks a step
    queue = iter(masks)

    def injected(x, p, generator, mask_shape=None):
        if generator is None or p == 0.0:
            return x
        keep = torch.from_numpy(next(queue).copy())
        assert tuple(keep.shape) == tuple(x.shape)
        return torch.where(keep, x / (1.0 - p), 0.0)

    monkeypatch.setattr(port_attention, "_dropout", injected)
    a = args()
    ctx = tgat_np.build(a, data=p_data())
    np.testing.assert_array_equal(ctx.node_x.numpy(), node_x)
    load_tgat_params(params, ctx.encoder, ctx.decoder)
    p_out = tgat_np.run(ctx, a)
    assert next(queue, None) is None  # every JAX mask was used, in order
    compare(p_out, j_out, "TGAT")


def test_tgat_example_script_runs_on_the_cpu():
    out = tgat_np.main(["--dataset", "synthetic-120-800", "--device", "cpu", "--num-classes",
                        "3", "--time-dim", "4", "--embed-dim", "8", "--n-nbrs", "3", "2"])
    assert np.isfinite(out["loss"][0]) and 0.0 < out["test_ndcg"] <= 1.0
