"""The TGN node-property path of the port against the JAX package on the CPU.

* ``NodePredictor`` against flax on the same weights (the node head's
  ``_MLP_0`` tree through ``load_tgn_params`` and ``load_tgat_params``).
* ``ndcg_at_k`` against JAX's with tied scores (ties decide which gains
  count), all-zero label rows, masked rows and ``k`` above the class count.
* The soft-label loss against ``optax.softmax_cross_entropy``.
* One ``build_tgn_node_cores`` train step against the JAX example's
  ``train_core`` (copied below) on the same hook-enriched batch and a memory
  state with pending messages, through ``sgd(1.0)`` so the weight change is
  the gradient: loss, every gradient and the committed memory within 1e-5,
  integer state exact (the attention weights' gradients are zero in both:
  the label nodes' rows receive no messages on these batches). ``eval_core`` over consecutive batches likewise,
  NDCG within 1e-5.
* A batch without labels moves neither the weights nor Adam's state (its
  step count included), and still commits the memory, as JAX's
  ``jnp.where(has, ...)`` keeps them.
* ROADMAP.md fault 14: a label node outside the dedup hook's union reads
  embedding row U - 1 in both packages; a hand-built batch shows it, and
  the count on the test stream is the same in both.

Sizes: the synthetic stream of 120 nodes and 800 edges with 4 classes and
8-dim edge features, K = 5 recency neighbours, memory/time/embed dims
16/8/16.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from examples._datasets import load_dataset as j_load_dataset
from tgm_tpu import DGData as JDGData
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
from tgm_tpu.nn.encoder.tgn import TGNMemoryState as JState
from tgm_tpu.nn.encoder.tgn import tgn_store_messages as j_tgn_store_messages
from tgm_tpu_torch import DGData, DGDataLoader, DGraph
from tgm_tpu_torch.core.batch import DGBatch
from tgm_tpu_torch.eval import ndcg_at_k
from tgm_tpu_torch.examples._datasets import load_dataset
from tgm_tpu_torch.hooks import DeduplicationHook, HookManager, RecencyNeighborHook
from tgm_tpu_torch.hooks.dedup import map_to_local
from tgm_tpu_torch.nn import TGAT, GraphAttentionEmbedding, NodePredictor, TGNMemory
from tgm_tpu_torch.nn import TGNMemoryState
from tgm_tpu_torch.train import build_local_edges, build_tgn_node_cores
from tgm_tpu_torch.train.programs import soft_label_ce
from tgm_tpu_torch.weights import load_tgat_params, load_tgn_params

N, C, K, MEM, TIME, EMB, EDGE_DIM = 120, 4, 5, 16, 8, 16, 8
DATASET = "synthetic-120-800"
STATE_FIELDS = ("mem", "last_update", "s_other", "s_t", "s_raw", "s_valid",
                "d_other", "d_t", "d_raw", "d_valid")
INT_FIELDS = ("last_update", "s_other", "s_t", "s_valid", "d_other", "d_t", "d_valid")
BATCH_FIELDS = ("edge_src", "edge_dst", "edge_time", "edge_valid", "edge_ids", "edge_x",
                "node_y_time", "node_y_nids", "node_y", "node_y_valid", "unique_nids",
                "num_unique", "global_to_local")
HOP_FIELDS = ("seed_nids", "seed_times", "nbr_nids", "nbr_edge_time", "nbr_edge_x")


# ---------------------------------------------------------------------- #
# The JAX example's cores (examples/nodeproppred/tgn.py:90-149)
# ---------------------------------------------------------------------- #
def jax_cores(memory, encoder, decoder, opt, num_nodes):
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
            logits = encode(p, mem_state, batch)
            loss = optax.softmax_cross_entropy(logits, batch.node_y)
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
        logits = encode(params, mem_state, batch)
        ndcg = j_ndcg_at_k(logits, batch.node_y, k=10, row_valid=batch.node_y_valid)
        mem_state = commit(params, mem_state, batch)
        return (params, mem_state), (jnp.where(has, ndcg, 0.0), has)

    return jax.jit(train_core), jax.jit(eval_core), jax.jit(encode)


def jax_modules():
    return (JMemory(num_nodes=N, raw_msg_dim=EDGE_DIM, memory_dim=MEM, time_dim=TIME),
            JGAE(in_channels=MEM, out_channels=EMB, msg_dim=EDGE_DIM, time_dim=TIME),
            JNodePredictor(in_dim=EMB, out_dim=C))


def port_modules():
    return (TGNMemory(N, EDGE_DIM, MEM, TIME), GraphAttentionEmbedding(MEM, EMB, EDGE_DIM, TIME),
            NodePredictor(EMB, C))


def jax_params(memory, encoder, decoder, seed=7):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    e4 = jnp.zeros(4, jnp.int32)
    return {"mem": memory.init(k1, memory.init_state(), e4),
            "enc": encoder.init(k2, jnp.zeros((8, MEM)), jnp.zeros(8, jnp.int32), e4, e4, e4,
                                jnp.zeros((4, EDGE_DIM)), jnp.ones(4, bool)),
            "dec": decoder.init(k3, jnp.zeros((1, EMB)))}


def random_state(rng, t_max):
    """A memory state with pending messages on most rows; the dump row pristine."""
    n1 = N + 1
    last = rng.integers(0, t_max // 2, n1).astype(np.int32)
    st = dict(
        mem=rng.normal(scale=0.5, size=(n1, MEM)).astype(np.float32), last_update=last,
        s_other=rng.integers(-1, N, n1).astype(np.int32),
        s_t=(last + rng.integers(0, t_max // 2, n1)).astype(np.int32),
        s_raw=rng.normal(size=(n1, EDGE_DIM)).astype(np.float32), s_valid=rng.random(n1) < 0.7,
        d_other=rng.integers(-1, N, n1).astype(np.int32),
        d_t=(last + rng.integers(0, t_max // 2, n1)).astype(np.int32),
        d_raw=rng.normal(size=(n1, EDGE_DIM)).astype(np.float32), d_valid=rng.random(n1) < 0.7,
    )
    for name in STATE_FIELDS:
        st[name][N] = -1 if name in ("s_other", "d_other") else 0
    return st


def to_jax_state(st):
    return JState(**{k: jnp.asarray(v) for k, v in st.items()})


def to_port_state(st):
    return TGNMemoryState(**{k: torch.from_numpy(np.array(v)) for k, v in st.items()})


def assert_state_close(got, want, atol):
    for name in STATE_FIELDS:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if name in INT_FIELDS:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=name)


def jax_hook_batches(data, bsize, split=0):
    """Every batch of a JAX split through the recency hook seeded by the
    label nodes and the dedup hook, as the JAX example registers them."""
    hm = JHookManager(keys=["all"])
    hm.register_shared(JRecency(N, [K], ["node_y_nids"], ["node_y_time"], edge_dim=EDGE_DIM))
    hm.register_shared(JDedup(N, seed_nodes_keys=["nbr_nids"]))
    with hm.activate("all"):
        return list(JLoader(JDGraph(data.split()[split]), bsize, hook_manager=hm))


def port_batch(jb):
    up = lambda x: torch.from_numpy(np.array(x))
    b = DGBatch(*(up(getattr(jb, f)) for f in ("edge_src", "edge_dst", "edge_time", "edge_valid")))
    for f in BATCH_FIELDS[4:]:
        setattr(b, f, up(getattr(jb, f)))
    for f in HOP_FIELDS:
        setattr(b, f, [up(h) for h in getattr(jb, f)])
    b.num_node_labels = int(np.asarray(jb.node_y_valid).sum())
    return b


def j_data():
    return j_load_dataset(DATASET, edge_dim=EDGE_DIM, node_label_classes=C)[0]


# ---------------------------------------------------------------------- #
# NodePredictor, NDCG, the loss
# ---------------------------------------------------------------------- #
def test_node_predictor_matches_flax_through_both_loaders():
    jmods = jax_modules()
    params = jax_params(*jmods)
    assert set(params["dec"]["params"]) == {"_MLP_0"}
    z = np.random.default_rng(0).normal(size=(9, EMB)).astype(np.float32)
    want = np.asarray(jmods[2].apply(params["dec"], jnp.asarray(z)))
    mods = port_modules()
    load_tgn_params(params, *mods)
    np.testing.assert_allclose(mods[2](torch.from_numpy(z)).detach().numpy(), want, rtol=0,
                               atol=1e-6)
    # The TGAT loader takes the same head.
    jt = JTGAT(node_dim=3, edge_dim=EDGE_DIM, time_dim=TIME, embed_dim=EMB, num_layers=1)
    hop = lambda *s: [jnp.zeros(s, jnp.int32)]
    tparams = {"enc": jt.init(jax.random.PRNGKey(1), jnp.zeros((N, 3)), hop(4), hop(4),
                              hop(4, K), [jnp.zeros((4, K, EDGE_DIM))], hop(4, K)),
               "dec": params["dec"]}
    enc, dec = TGAT(3, EDGE_DIM, TIME, EMB, 1), NodePredictor(EMB, C)
    load_tgat_params(tparams, enc, dec)
    np.testing.assert_allclose(dec(torch.from_numpy(z)).detach().numpy(), want, rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("k", [3, 10])
@pytest.mark.parametrize("masked", [False, True])
def test_ndcg_matches_jax_with_ties(k, masked):
    rng = np.random.default_rng(k)
    B, Cn = 64, 6
    scores = np.round(rng.normal(size=(B, Cn)) * 2) / 2  # many exact ties
    scores[:8] = 0.25  # whole rows tied: the lowest classes count
    labels = rng.random((B, Cn)) * (rng.random((B, Cn)) < 0.5)
    labels[8:12] = 0.0  # all-zero rows score 0
    valid = rng.random(B) < 0.8 if masked else None
    args = [scores.astype(np.float32), labels.astype(np.float32)]
    want = float(j_ndcg_at_k(*map(jnp.asarray, args), k=k,
                             row_valid=None if valid is None else jnp.asarray(valid)))
    got = float(ndcg_at_k(*map(torch.from_numpy, args), k=k,
                          row_valid=None if valid is None else torch.from_numpy(valid)))
    assert abs(got - want) <= 1e-6, (got, want)
    # Tied rows: a stable order counts classes 0..k-1; labels there differ
    # from the rest, so an unstable order would read another value.
    lab = np.zeros((1, 5), np.float32)
    lab[0, 0], lab[0, 4] = 1.0, 2.0
    tie = np.zeros((1, 5), np.float32)
    got = float(ndcg_at_k(torch.from_numpy(tie), torch.from_numpy(lab), k=2))
    want = float(j_ndcg_at_k(jnp.asarray(tie), jnp.asarray(lab), k=2))
    assert got == pytest.approx(want, abs=1e-7) and got == pytest.approx(1.0 / (2.0 + 1 / np.log2(3)))


def test_soft_label_loss_matches_optax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(16, C)).astype(np.float32) * 3
    y = rng.random((16, C)).astype(np.float32)
    y /= y.sum(1, keepdims=True)
    mask = rng.random(16) < 0.7
    loss = optax.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(y))
    want = float(jnp.sum(loss * mask) / max(mask.sum(), 1))
    got = float(soft_label_ce(torch.from_numpy(logits), torch.from_numpy(y),
                              torch.from_numpy(mask)))
    assert abs(got - want) <= 1e-6
    assert float(soft_label_ce(torch.from_numpy(logits), torch.from_numpy(y),
                               torch.zeros(16, dtype=torch.bool))) == 0.0


# ---------------------------------------------------------------------- #
# The cores against the JAX example's
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("index", [3, -1], ids=["full_batch", "padded_tail"])
def test_one_train_step_matches_jax_train_core(index):
    data = j_data()
    jb = jax_hook_batches(data, 60)[index]
    assert bool(np.asarray(jb.node_y_valid).any())
    st = random_state(np.random.default_rng(5), int(data.time.max()))
    jmods = jax_modules()
    params = jax_params(*jmods)
    opt = optax.sgd(1.0)
    j_train, _, _ = jax_cores(*jmods, opt, N)
    (j_params, _, j_state), (j_loss, j_has) = j_train((params, opt.init(params),
                                                       to_jax_state(st)), jb)

    mods = port_modules()
    load_tgn_params(params, *mods)
    t_opt = torch.optim.SGD([p for m in mods for p in m.parameters()], lr=1.0)
    train_core, _ = build_tgn_node_cores(*mods, t_opt, N)
    state, (loss, has) = train_core(to_port_state(st), port_batch(jb))
    assert bool(has) and bool(j_has) and not loss.requires_grad
    assert abs(float(loss) - float(j_loss)) <= 1e-5, (float(loss), float(j_loss))
    # sgd(1.0): the JAX gradient is the weight change; the port's is in .grad.
    j_grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b), params, j_params)
    want = port_modules()
    load_tgn_params(j_grads, *want)
    worst, zero = 0.0, []
    for m, w in zip(mods, want):
        for (name, p), (_, q) in zip(m.named_parameters(), w.named_parameters()):
            gap = float((p.grad - q.detach()).abs().max())
            worst = max(worst, gap)
            assert gap <= 1e-5, name
            if not bool(p.grad.any()):
                zero.append(name)
    print(f"largest gradient difference {worst:.3g}; zero gradients: {zero}")
    # Messages aggregate at the neighbours' rows and the logits read the
    # label nodes' rows, so the attention weights get a gradient only where
    # a label node is another's neighbour: in neither package here. The
    # memory, lin_skip and the head always do.
    assert "gru.weight_ih" not in zero and "lin_skip.weight" not in zero
    assert "model.0.weight" not in zero
    assert_state_close(state, j_state, atol=1e-5)


def test_eval_core_matches_jax_over_batches():
    data = j_data()
    batches = jax_hook_batches(data, 60, split=1)[:4]
    st = random_state(np.random.default_rng(6), int(data.time.max()))
    jmods = jax_modules()
    params = jax_params(*jmods, seed=3)
    _, j_eval, _ = jax_cores(*jmods, optax.sgd(1.0), N)
    mods = port_modules()
    load_tgn_params(params, *mods)
    _, eval_core = build_tgn_node_cores(*mods, None, N)
    j_state, state = to_jax_state(st), to_port_state(st)
    for i, jb in enumerate(batches):
        (_, j_state), (j_ndcg, j_has) = j_eval((params, j_state), jb)
        state, (ndcg, has) = eval_core(state, port_batch(jb))
        assert bool(has) == bool(j_has)
        assert abs(float(ndcg) - float(j_ndcg)) <= 1e-5, (i, float(ndcg), float(j_ndcg))
        assert_state_close(state, j_state, atol=1e-5)


def test_label_less_batch_moves_neither_weights_nor_adam():
    data = j_data()
    batches = jax_hook_batches(data, 8)  # 8 events a batch: some hold no label
    empty = [i for i, b in enumerate(batches) if not np.asarray(b.node_y_valid).any()]
    full = [i for i, b in enumerate(batches) if np.asarray(b.node_y_valid).any()]
    assert empty and full
    first, blank = full[0], next(i for i in empty if i > full[0])
    st = random_state(np.random.default_rng(7), int(data.time.max()))

    jmods = jax_modules()
    params = jax_params(*jmods)
    opt = optax.adam(1e-3)
    j_train, _, _ = jax_cores(*jmods, opt, N)
    carry = (params, opt.init(params), to_jax_state(st))
    carry, _ = j_train(carry, batches[first])
    (j_params, j_opt, j_state), (j_loss, j_has) = j_train(carry, batches[blank])
    assert not bool(j_has) and float(j_loss) == 0.0
    assert int(j_opt[0].count) == 1  # JAX keeps Adam's step count too

    mods = port_modules()
    load_tgn_params(params, *mods)
    t_opt = torch.optim.Adam([p for m in mods for p in m.parameters()], lr=1e-3)
    train_core, _ = build_tgn_node_cores(*mods, t_opt, N)
    state = to_port_state(st)
    state, _ = train_core(state, port_batch(batches[first]))
    before_w = [p.detach().clone() for m in mods for p in m.parameters()]
    before_opt = copy.deepcopy(t_opt.state_dict())
    before_mem = state.mem.clone()
    state, (loss, has) = train_core(state, port_batch(batches[blank]))
    assert not bool(has) and float(loss) == 0.0
    for p, q in zip((p for m in mods for p in m.parameters()), before_w):
        torch.testing.assert_close(p.detach(), q, rtol=0, atol=0)
    after_opt = t_opt.state_dict()["state"]
    for key, s in before_opt["state"].items():
        assert float(after_opt[key]["step"]) == float(s["step"]) == 1.0
        for name in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(after_opt[key][name], s[name], rtol=0, atol=0)
    assert not torch.equal(state.mem, before_mem)  # the commit ran
    assert_state_close(state, j_state, atol=1e-5)
    want = port_modules()
    load_tgn_params(j_params, *want)
    for m, w in zip(mods, want):
        for p, q in zip(m.parameters(), w.parameters()):
            assert float((p - q).detach().abs().max()) <= 1e-5
    # The label count is read on the host only: a batch without it raises.
    uncounted = port_batch(batches[blank])
    del uncounted.num_node_labels
    with pytest.raises(ValueError, match="num_node_labels"):
        train_core(state, uncounted)


# ---------------------------------------------------------------------- #
# ROADMAP.md fault 14: label nodes outside the dedup union
# ---------------------------------------------------------------------- #
def fault14_data(pkg):
    """Node 0's label shares edge 1's time and follows it on the timeline; a
    two-event batch boundary falls between them, and the next batch's edge
    does not touch node 0."""
    t = np.array([1, 2, 3, 4, 5, 6])
    ei = np.array([[0, 1], [0, 2], [3, 4], [1, 2], [3, 1], [4, 2]], np.int32)
    ex = np.random.default_rng(0).normal(size=(6, EDGE_DIM)).astype(np.float32)
    return pkg.from_raw(t, ei, ex, node_y_time=np.array([2]), node_y_nids=np.array([0]),
                        node_y=np.eye(C, dtype=np.float32)[[1]], time_delta="s")


def test_unseen_label_node_reads_the_last_row_like_jax():
    n = 5
    hm, jhm = HookManager(keys=["all"]), JHookManager(keys=["all"])
    hm.register_shared(RecencyNeighborHook(n, [K], ["node_y_nids"], ["node_y_time"],
                                           edge_dim=EDGE_DIM, device="cpu"))
    hm.register_shared(DeduplicationHook(n, seed_nodes_keys=["nbr_nids"]))
    jhm.register_shared(JRecency(n, [K], ["node_y_nids"], ["node_y_time"], edge_dim=EDGE_DIM))
    jhm.register_shared(JDedup(n, seed_nodes_keys=["nbr_nids"]))
    with hm.activate("all"), jhm.activate("all"):
        batches = list(DGDataLoader(DGraph(fault14_data(DGData)), 2, hook_manager=hm,
                                    device="cpu"))
        j_batches = list(JLoader(JDGraph(fault14_data(JDGData)), 2, hook_manager=jhm))
    b, jb = batches[1], j_batches[1]
    assert int(b.node_y_nids[0]) == 0 and bool(b.node_y_valid[0])
    assert int(map_to_local(b.global_to_local, b.node_y_nids)[0]) == -1  # unseen
    assert int(j_map_to_local(jb.global_to_local, jb.node_y_nids)[0]) == -1
    assert 1 in b.nbr_nids[0][0].tolist()  # node 0 has history: its neighbour is seen

    jmods = (JMemory(num_nodes=n, raw_msg_dim=EDGE_DIM, memory_dim=MEM, time_dim=TIME),
             jax_modules()[1], jax_modules()[2])
    params = jax_params(*jmods)
    _, _, j_encode = jax_cores(*jmods, optax.sgd(1.0), n)
    rng = np.random.default_rng(1)
    st = random_state(rng, 6)
    st = {k: v[: n + 1] if v.shape[0] == N + 1 else v for k, v in st.items()}
    st["mem"][n], st["last_update"][n] = 0, 0
    want = np.asarray(j_encode(params, to_jax_state(st), jb))
    mods = (TGNMemory(n, EDGE_DIM, MEM, TIME), *port_modules()[1:])
    load_tgn_params(params, *mods)
    with torch.no_grad():
        z_mem, last = mods[0].stage(to_port_state(st), b.unique_nids)
        z = mods[1](z_mem, last, *build_local_edges(b, n))
        last_row = mods[2](z[-1:]).numpy()
    np.testing.assert_allclose(last_row, want[:1], rtol=0, atol=1e-5)
    # The eval core reads the same row: its NDCG is the last row's.
    _, eval_core = build_tgn_node_cores(*mods, None, n)
    _, (ndcg, has) = eval_core(to_port_state(st), b)
    want_ndcg = j_ndcg_at_k(jnp.asarray(last_row), jb.node_y[:1], k=10)
    assert bool(has) and abs(float(ndcg) - float(want_ndcg)) <= 1e-6


@pytest.mark.parametrize("bsize", [4, 50])
def test_unseen_label_nodes_on_the_test_stream_count_like_jax(bsize):
    """How many of the train split's label rows fall outside the dedup
    union: the same in both packages (printed). Labels fall every 21
    events, so a batch of 3 or 7 events always cuts the timeline at the
    same place; 4 does not, and its short batches rarely hold the label
    node as an endpoint."""
    data = j_data()
    counts = {"jax": sum(
        int(np.sum((np.asarray(j_map_to_local(b.global_to_local, b.node_y_nids)) == -1)
                   & np.asarray(b.node_y_valid))) for b in jax_hook_batches(data, bsize))}
    hm = HookManager(keys=["all"])
    hm.register_shared(RecencyNeighborHook(N, [K], ["node_y_nids"], ["node_y_time"],
                                           edge_dim=EDGE_DIM, device="cpu"))
    hm.register_shared(DeduplicationHook(N, seed_nodes_keys=["nbr_nids"]))
    pdata = load_dataset(DATASET, edge_dim=EDGE_DIM, node_label_classes=C)[0]
    with hm.activate("all"):
        counts["port"] = sum(
            int(((map_to_local(b.global_to_local, b.node_y_nids) == -1) & b.node_y_valid).sum())
            for b in DGDataLoader(DGraph(pdata.split()[0]), bsize, hook_manager=hm,
                                  device="cpu"))
    n_labels = int(JDGraph(data.split()[0]).num_node_labels)
    print(f"batch {bsize}: label rows outside the dedup union {counts} of {n_labels}")
    assert counts["port"] == counts["jax"]
    if bsize == 4:
        assert counts["port"] > 0
