"""DyGFormer node property prediction: the seen-node hook and the example's
flow in both packages.

Stream: the synthetic dataset of 120 nodes and 800 edges with 4 label
classes (a label every 20th edge) and 8-dim edge features, split 70/15/15;
batches of 60 events, K = 5 recency neighbours (feature layout), channel
8, time 8, embed 16, one layer, ``max_input_sequence_length`` 8, static
node features ``normal(N, 8)`` from the seed, Adam at lr 1e-3, dropout 0.

* ``EdgeEventsSeenNodesTrackHook`` through both packages' loaders, batch by
  batch: ``batch_nodes_mask``, ``seen_nodes`` and the state exact.
* The JAX example's flow (``examples/nodeproppred/dygformer.py``: train,
  val, the hooks reset, two epochs; train and val streamed through the
  hooks again; test) against the port's example (``build`` + ``run``) on
  the same weights (JAX's init, loaded by ``load_dygformer_params``):
  every per-batch loss within 5e-3 and the first within 1e-5, val NDCG
  within 0.01 per epoch, test NDCG within 0.02. The gaps are printed.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import optax

from examples._datasets import load_dataset as j_load_dataset
from tgm_tpu import DGDataLoader as JLoader
from tgm_tpu import DGraph as JDGraph
from tgm_tpu.eval.metrics import ndcg_at_k as j_ndcg_at_k
from tgm_tpu.hooks import EdgeEventsSeenNodesTrackHook as JSeen
from tgm_tpu.hooks import HookManager as JHookManager
from tgm_tpu.hooks import RecencyNeighborHook as JRecency
from tgm_tpu.nn import DyGFormer as JDyGFormer
from tgm_tpu.nn import NodePredictor as JNodePredictor
from tgm_tpu_torch import DGraph
from tgm_tpu_torch.data import DGDataLoader
from tgm_tpu_torch.examples._datasets import load_dataset
from tgm_tpu_torch.examples.nodeproppred import dygformer as dyg_np
from tgm_tpu_torch.hooks import EdgeEventsSeenNodesTrackHook, HookManager
from tgm_tpu_torch.weights import load_dygformer_params

DATASET, C, EDGE_DIM, BSIZE, K, CH, TIME, EMB, SEQ = "synthetic-120-800", 4, 8, 60, 5, 8, 8, 16, 8
EPOCHS, LR, SEED = 2, 1e-3, 1337


def args(**kw):
    base = dict(dataset=DATASET, seed=SEED, bsize=BSIZE, epochs=EPOCHS, lr=LR, dropout=0.0,
                n_nbrs=K, time_dim=TIME, channel_dim=CH, embed_dim=EMB, compute_bf16="auto",
                max_seq_len=SEQ, num_classes=C, device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


def j_data():
    return j_load_dataset(DATASET, edge_dim=EDGE_DIM, node_label_classes=C)[0]


def p_data():
    return load_dataset(DATASET, edge_dim=EDGE_DIM, node_label_classes=C)[0]


def test_seen_node_hook_matches_jax_through_the_loaders():
    jd, pd = j_data(), p_data()
    n = jd.num_nodes
    jhm, phm = JHookManager(keys=["all"]), HookManager(keys=["all"])
    jhm.register_shared(JSeen(n))
    phm.register_shared(EdgeEventsSeenNodesTrackHook(n, device="cpu"))
    seen_any = False
    for split, (jpart, ppart) in enumerate(zip(jd.split(), pd.split())):
        with jhm.activate("all"), phm.activate("all"):
            jl = JLoader(JDGraph(jpart), BSIZE, hook_manager=jhm)
            pl = DGDataLoader(DGraph(ppart), BSIZE, hook_manager=phm, device="cpu")
            for b, (jb, pb) in enumerate(zip(jl, pl)):
                for name in ("batch_nodes_mask", "seen_nodes"):
                    np.testing.assert_array_equal(getattr(pb, name).numpy(),
                                                  np.asarray(getattr(jb, name)),
                                                  err_msg=f"{name} @ {split}.{b}")
                seen_any |= bool((pb.batch_nodes_mask & pb.node_y_valid).any())
                assert not (pb.batch_nodes_mask & ~pb.node_y_valid).any()
        (jhook,), (phook,) = jhm._shared_hooks, phm._shared_hooks
        np.testing.assert_array_equal(phook.state.numpy(), np.asarray(jhook.state))
    assert seen_any


def run_jax():
    """The JAX example's flow (examples/nodeproppred/dygformer.py:46-170) at
    the test's sizes, dropout 0; returns its initial parameters and its
    per-batch losses, val and test NDCG."""
    data = j_data()
    rng = np.random.default_rng(SEED)
    data.static_node_x = rng.normal(size=(data.num_nodes, 8)).astype(np.float32)
    num_nodes = data.num_nodes
    node_x = jnp.asarray(data.static_node_x)
    dgs = [JDGraph(s) for s in data.split()]
    hm = JHookManager(keys=["all"])
    hm.register_shared(JRecency(num_nodes, [K], ["node_y_nids"], ["node_y_time"],
                                edge_dim=EDGE_DIM))
    hm.register_shared(JSeen(num_nodes))
    encoder = JDyGFormer(node_feat_dim=8, edge_x_dim=EDGE_DIM, time_feat_dim=TIME,
                         channel_embedding_dim=CH, output_dim=EMB, max_input_sequence_length=SEQ,
                         dropout=0.0, num_layers=1)
    decoder = JNodePredictor(in_dim=EMB, out_dim=C)
    opt = optax.adam(LR)

    def encode(p, batch):
        nids, t = batch.node_y_nids, batch.node_y_time
        two = lambda x: jnp.concatenate([x, x])
        zs, _ = encoder.apply(p["enc"], node_x, nids, nids, t, two(batch.nbr_nids[0]),
                              two(batch.nbr_edge_time[0]), two(batch.nbr_edge_x[0]))
        return decoder.apply(p["dec"], zs)

    k1, k2 = jax.random.split(jax.random.PRNGKey(SEED))
    L = 4
    z = lambda *s: jnp.zeros(s, jnp.int32)
    params = jax.jit(lambda: {
        "enc": encoder.init(k1, node_x, z(L), z(L), z(L), z(2 * L, K), z(2 * L, K),
                            jnp.zeros((2 * L, K, EDGE_DIM))),
        "dec": decoder.init(k2, jnp.zeros((1, EMB)))})()
    init_params = jax.tree_util.tree_map(np.asarray, params)
    opt_state = opt.init(params)

    @jax.jit
    def train_step(params, opt_state, batch):
        def loss_fn(p):
            loss = optax.softmax_cross_entropy(encode(p, batch), batch.node_y)
            m = (batch.node_y_valid & batch.batch_nodes_mask).astype(loss.dtype)
            return jnp.sum(loss * m) / jnp.maximum(m.sum(), 1.0)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    @jax.jit
    def eval_step(params, batch):
        return j_ndcg_at_k(encode(params, batch), batch.node_y, k=10,
                           row_valid=batch.node_y_valid & batch.batch_nodes_mask)

    def run(dg, train):
        nonlocal params, opt_state
        out = []
        with hm.activate("all"):
            for batch in JLoader(dg, BSIZE, hook_manager=hm):
                if train:
                    params, opt_state, loss = train_step(params, opt_state, batch)
                    out.append(float(loss))
                else:
                    out.append(float(eval_step(params, batch)))
        return out

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
    return init_params, out


def test_two_epochs_match_the_jax_example_flow():
    params, j_out = run_jax()
    a = args()
    ctx = dyg_np.build(a, data=p_data())
    load_dygformer_params(params, ctx.encoder, ctx.decoder)
    p_out = dyg_np.run(ctx, a)
    p_losses = np.concatenate([np.asarray(x, np.float64) for x in p_out["losses"]])
    j_losses = np.concatenate([np.asarray(x, np.float64) for x in j_out["losses"]])
    assert p_losses.shape == j_losses.shape and p_losses.size >= 2 * 5
    gap = np.abs(p_losses - j_losses)
    val_gap = max(abs(p - j) for p, j in zip(p_out["val_ndcg"], j_out["val_ndcg"]))
    test_gap = abs(p_out["test_ndcg"] - j_out["test_ndcg"])
    print(f"DyGFormer nodeprop: {p_losses.size} train batches, first-loss gap {gap[0]:.3g}, max "
          f"loss gap {gap.max():.3g}; val NDCG {j_out['val_ndcg']} (gap {val_gap:.3g}), test "
          f"NDCG {j_out['test_ndcg']:.6f} (gap {test_gap:.3g})")
    assert gap[0] <= 1e-5
    assert gap.max() <= 5e-3
    assert val_gap <= 0.01 and test_gap <= 0.02
    assert all(0.0 < v <= 1.0 for v in p_out["val_ndcg"]) and 0.0 < p_out["test_ndcg"] <= 1.0
    assert j_losses.max() - j_losses.min() > 1e-3  # the runs learned something


def test_example_script_runs_on_the_cpu():
    out = dyg_np.main(["--dataset", DATASET, "--device", "cpu", "--num-classes", "3",
                       "--time-dim", "4", "--channel-dim", "4", "--embed-dim", "8",
                       "--n-nbrs", "3"])
    assert np.isfinite(out["loss"][0]) and 0.0 < out["test_ndcg"] <= 1.0
