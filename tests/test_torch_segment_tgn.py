"""The TGN segment path of the port against the JAX package on the CPU.

* ``build_local_edges`` on hook-enriched batches (random negatives, the
  eid-layout recency hook and the dedup hook, both packages, the JAX draws
  injected): exact.
* ``GraphAttentionEmbedding`` against the flax module on the same weights
  (JAX's init, perturbed, loaded by ``weights.load_tgn_params``): output
  within 1e-5, the gradients of every parameter and of the node rows within
  1e-5, with invalid edges and local ids outside [0, U) that are clipped.
  Its dropout is drawn from the caller's generator only.
* One segment ``train_core`` step against the JAX segment ``train_core`` on
  the same batch and a memory state with pending messages, through
  ``optax.sgd(1.0)`` and ``torch.optim.SGD(lr=1.0)`` so the weight change is
  the gradient: loss within 1e-6, every leaf within 1e-5, the committed
  state's integer fields exact and floats within 1e-5; on a full batch and
  on the padded tail batch.
* ``eval_core`` over the val and test splits against JAX's (TGB candidates,
  the JAX ``neg_time`` draws injected), on a uniform and on a tie-heavy
  zipf stream (the port scores positives and candidates in one decoder
  call, JAX in two): per-batch MRR sums within 1e-5, integer memory and
  recency state exact, memory within 1e-5.
* ``TGNPipeline(rowwise=False)``: train steps against the JAX pipeline's
  (its negatives injected), losses within 1e-5, state exact or within 1e-4,
  ``forward_only`` within 1e-4; ``eval_step`` raises, as the JAX assert.

Sizes: 120 nodes, 800 edges (batch 100, 5 candidates), K = 10,
memory/time/embed dims 16/8/16, 8-dim edge features; the pipeline 40 nodes,
the 231 train edges of 330 (batch 64), dims 8/6/8, K = 5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tgm_tpu import DGData as JDGData
from tgm_tpu import DGraph as JDGraph
from tgm_tpu.hooks import DeduplicationHook as JDedup
from tgm_tpu.hooks import HookManager as JHookManager
from tgm_tpu.hooks import RandomNegativeEdgeSamplerHook as JRandomNeg
from tgm_tpu.hooks import RecencyNeighborHook as JRecency
from tgm_tpu.hooks import TGBNegativeEdgeSamplerHook as JTGB
from tgm_tpu.hooks.neighbors import recency_eid_init as j_recency_eid_init
from tgm_tpu.nn import LinkPredictor as JLinkPredictor
from tgm_tpu.nn.encoder.tgn import GraphAttentionEmbedding as JGAE
from tgm_tpu.nn.encoder.tgn import TGNMemory as JMemory
from tgm_tpu.nn.encoder.tgn import TGNMemoryState as JState
from tgm_tpu.nn.encoder.tgn import tgn_init_state as j_tgn_init_state
from tgm_tpu.train import DeviceEdgeStream as JStream
from tgm_tpu.train import TGNPipeline as JPipeline
from tgm_tpu.train.programs import build_local_edges as j_build_local_edges
from tgm_tpu.train.programs import build_tgn_hook_cores as j_build_cores
from tgm_tpu_torch import DGData, DGraph
from tgm_tpu_torch.core.batch import DGBatch
from tgm_tpu_torch.hooks import (
    DeduplicationHook,
    HookManager,
    RecencyNeighborHook,
    TGBNegativeEdgeSamplerHook,
)
from tgm_tpu_torch.hooks.neighbors import recency_eid_init
from tgm_tpu_torch.nn import GraphAttentionEmbedding, LinkPredictor, TGNMemory, TGNMemoryState
from tgm_tpu_torch.nn import tgn_init_state
from tgm_tpu_torch.train import (
    DeviceEdgeStream,
    TGNPipeline,
    build_local_edges,
    build_tgn_hook_cores,
    hook_epoch,
)
from tgm_tpu_torch.weights import load_tgn_params

N, E, BSIZE, Q, K, MEM, TIME, EMB, EDGE_DIM = 120, 800, 100, 5, 10, 16, 8, 16, 8
STATE_FIELDS = ("mem", "last_update", "s_other", "s_t", "s_raw", "s_valid",
                "d_other", "d_t", "d_raw", "d_valid")
INT_FIELDS = ("last_update", "s_other", "s_t", "s_valid", "d_other", "d_t", "d_valid")
KEYS = (["edge_src", "edge_dst", "neg"], ["edge_time", "edge_time", "neg_time"])
DEDUP_KEYS = ["neg", "nbr_nids"]


def make_stream(popularity="uniform", seed=0):
    """Edges, times, features, the generator and a popularity vector (None:
    uniform; ``"zipf"``: the bench recipe's, where candidate scores tie)."""
    rng = np.random.default_rng(seed)
    pop = None
    if popularity == "zipf":
        pop = rng.zipf(1.4, size=N).astype(np.float64)
        pop /= pop.sum()
    src = rng.choice(N, E, p=pop)
    dst = rng.choice(N, E, p=pop)
    dst = np.where(dst == src, (dst + 1) % N, dst)
    t = np.sort(rng.integers(0, 2 * E, E))
    edge_x = rng.normal(size=(E, EDGE_DIM)).astype(np.float32)
    return src, dst, t, edge_x, rng, pop


def jax_modules(dropout=0.0):
    return (JMemory(num_nodes=N, raw_msg_dim=EDGE_DIM, memory_dim=MEM, time_dim=TIME),
            JGAE(in_channels=MEM, out_channels=EMB, msg_dim=EDGE_DIM, time_dim=TIME,
                 dropout=dropout),
            JLinkPredictor(node_dim=EMB, hidden_dim=EMB))


def port_modules(dropout=0.0):
    return (TGNMemory(N, EDGE_DIM, MEM, TIME),
            GraphAttentionEmbedding(MEM, EMB, EDGE_DIM, TIME, dropout=dropout),
            LinkPredictor(node_dim=EMB, hidden_dim=EMB))


def segment_enc_init(encoder, key, mem_dim, edge_dim):
    return encoder.init(key, jnp.zeros((8, mem_dim)), jnp.zeros(8, jnp.int32),
                        jnp.zeros(4, jnp.int32), jnp.zeros(4, jnp.int32), jnp.zeros(4, jnp.int32),
                        jnp.zeros((4, edge_dim)), jnp.ones(4, bool))


def jax_params(memory, encoder, decoder, seed=7):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    return {"mem": memory.init(k1, memory.init_state(), jnp.zeros(8, jnp.int32)),
            "enc": segment_enc_init(encoder, k2, MEM, EDGE_DIM),
            "dec": decoder.init(k3, jnp.zeros((1, EMB)), jnp.zeros((1, EMB)))}


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
    for name, fill in (("mem", 0), ("last_update", 0), ("s_other", -1), ("s_t", 0), ("s_raw", 0),
                       ("s_valid", False), ("d_other", -1), ("d_t", 0), ("d_raw", 0),
                       ("d_valid", False)):
        st[name][N] = fill
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


def jax_train_batches(src, dst, t, edge_x, indices):
    """The train split's batches at ``indices`` through the JAX random-negative,
    recency and dedup hooks, every batch before them pushed too."""
    data = JDGData.from_raw(t, np.stack([src, dst], 1), edge_x)
    dg = JDGraph(data.split()[0])
    hm = JHookManager(keys=["train"])
    hm.register("train", JRandomNeg(low=0, high=N))
    hm.register_shared(JRecency(N, [K], *KEYS, edge_dim=EDGE_DIM, edge_x_full=data.edge_x))
    hm.register_shared(JDedup(N, seed_nodes_keys=DEDUP_KEYS))
    stream = JStream(dg, BSIZE)
    fn, states = hm.as_transform("train", dg)
    fn = jax.jit(fn)
    out = {}
    for i in range(stream.num_batches):
        states, batch = fn(states, stream.batch_at(i))
        if i in indices or i - stream.num_batches in indices:
            out[i] = batch
    return [out[i % stream.num_batches] for i in indices]


def port_batch(jb):
    up = lambda x: torch.from_numpy(np.array(x))
    hop = lambda name: [up(getattr(jb, name)[0])]
    return DGBatch(up(jb.edge_src), up(jb.edge_dst), up(jb.edge_time), up(jb.edge_valid),
                   edge_x=up(jb.edge_x), neg=up(jb.neg), seed_nids=hop("seed_nids"),
                   nbr_nids=hop("nbr_nids"), nbr_edge_time=hop("nbr_edge_time"),
                   nbr_edge_x=hop("nbr_edge_x"), unique_nids=up(jb.unique_nids),
                   num_unique=up(jb.num_unique), global_to_local=up(jb.global_to_local))


# ---------------------------------------------------------------------- #
# build_local_edges
# ---------------------------------------------------------------------- #
def test_build_local_edges_matches_jax():
    src, dst, t, edge_x, _, _ = make_stream()
    for i, jb in zip((0, 3, -1), jax_train_batches(src, dst, t, edge_x, [0, 3, -1])):
        want = j_build_local_edges(jb, N)
        got = build_local_edges(port_batch(jb), N)
        for name, g, w in zip(("e_src", "e_dst", "e_t", "e_x", "valid"), got, want):
            assert tuple(g.shape) == tuple(w.shape), name
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        # The first batch finds no neighbours; later ones some, not all.
        assert not got[4].all() and bool(got[4].any()) == (i != 0)


# ---------------------------------------------------------------------- #
# GraphAttentionEmbedding
# ---------------------------------------------------------------------- #
def gae_inputs(seed, U=40, E_loc=300):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(U, MEM)).astype(np.float32)
    last = rng.integers(0, 5000, U).astype(np.int32)
    e_src = rng.integers(-2, U + 2, E_loc).astype(np.int32)  # clipped into [0, U)
    e_dst = rng.integers(-2, U + 2, E_loc).astype(np.int32)
    e_dst[:60] = 3  # one row aggregates many edges
    e_t = rng.integers(0, 5000, E_loc).astype(np.int32)
    e_x = rng.normal(size=(E_loc, EDGE_DIM)).astype(np.float32)
    valid = rng.random(E_loc) < 0.8
    return x, last, e_src, e_dst, e_t, e_x, valid


def perturbed_enc_params(seed=0):
    enc = jax_modules()[1]
    p = segment_enc_init(enc, jax.random.PRNGKey(seed), MEM, EDGE_DIM)
    rng = np.random.default_rng(seed)
    return enc, jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + rng.normal(scale=0.1, size=a.shape)
                              .astype(np.float32)), p)


def load_encoder(enc_params, encoder):
    mems, _, decs = jax_modules()
    full = jax_params(mems, jax_modules()[1], decs)
    full["enc"] = enc_params
    load_tgn_params(full, TGNMemory(N, EDGE_DIM, MEM, TIME), encoder,
                    LinkPredictor(node_dim=EMB, hidden_dim=EMB))


def test_graph_attention_embedding_matches_flax():
    jenc, p = perturbed_enc_params()
    args = gae_inputs(1)
    w_out = np.random.default_rng(2).normal(size=(40, EMB)).astype(np.float32)
    jargs = [jnp.asarray(a) for a in args]
    # Jitted, as the JAX package runs it: XLA fuses Time2Vec's phase into one
    # rounding, as the port's addcmul does (ROADMAP.md fault 9).
    want = jax.jit(jenc.apply)(p, *jargs)
    enc = GraphAttentionEmbedding(MEM, EMB, EDGE_DIM, TIME, dropout=0.0)
    load_encoder(p, enc)
    targs = [torch.from_numpy(a) for a in args]
    x = targs[0].requires_grad_()
    got = enc(*targs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)

    def j_loss(params, xx):
        return jnp.sum(jenc.apply(params, xx, *jargs[1:]) * w_out)

    gp, gx = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(p, jargs[0])
    (got * torch.from_numpy(w_out)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx), rtol=0, atol=1e-5)
    gp = gp["params"]
    pairs = [(enc.time_enc.w.weight.grad.T, gp["time_enc"]["w"]),
             (enc.time_enc.w.bias.grad, gp["time_enc"]["b"])]
    for name in ("lin_query", "lin_key", "lin_value", "lin_edge", "lin_skip"):
        lin = getattr(enc, name)
        pairs.append((lin.weight.grad.T, gp[name]["kernel"]))
        if lin.bias is not None:
            pairs.append((lin.bias.grad, gp[name]["bias"]))
    for g, w in pairs:
        scale = max(1.0, float(np.abs(np.asarray(w)).max()))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5 * scale)
    assert all(float(np.abs(np.asarray(w)).max()) > 0 for _, w in pairs)


def test_graph_attention_dropout_follows_the_generator():
    args = [torch.from_numpy(a) for a in gae_inputs(3)]
    enc = GraphAttentionEmbedding(MEM, EMB, EDGE_DIM, TIME, dropout=0.3).train()
    plain = enc(*args)
    torch.testing.assert_close(enc(*args), plain, rtol=0, atol=0)  # train mode, no generator
    gen = lambda: torch.Generator().manual_seed(11)
    a, b = enc(*args, generator=gen()), enc(*args, generator=gen())
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float((a - plain).detach().abs().max()) > 1e-3


# ---------------------------------------------------------------------- #
# One train step and the eval core, against JAX's cores
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("index", [2, -1], ids=["full_batch", "padded_tail"])
def test_one_segment_train_step_matches_jax_train_core(index):
    src, dst, t, edge_x, rng, _ = make_stream()
    (jb,) = jax_train_batches(src, dst, t, edge_x, [index])
    assert np.asarray(jb.edge_valid).all() == (index >= 0)
    st = random_state(rng, int(t.max()))

    jmods = jax_modules()
    params = jax_params(*jmods)
    opt = optax.sgd(1.0)
    j_train, _ = j_build_cores(*jmods, opt, N)  # the default style: segment
    (j_params, _, j_state, _), j_loss = jax.jit(j_train)(
        (params, opt.init(params), to_jax_state(st), jax.random.PRNGKey(0)), jb)

    mods = port_modules()
    load_tgn_params(params, *mods)
    t_opt = torch.optim.SGD([p for m in mods for p in m.parameters()], lr=1.0)
    train_core, _ = build_tgn_hook_cores(*mods, t_opt, N)
    (state, gen), loss = train_core((to_port_state(st), None), port_batch(jb))
    assert gen is None and not loss.requires_grad
    assert abs(float(loss) - float(j_loss)) <= 1e-6, (float(loss), float(j_loss))
    want = port_modules()
    load_tgn_params(j_params, *want)
    for m, w, name in zip(mods, want, ("mem", "enc", "dec")):
        for (k, p), (_, q) in zip(m.named_parameters(), w.named_parameters()):
            diff = float((p - q).detach().abs().max())
            assert diff <= 1e-5, (name, k, diff)
    moved = jax.tree_util.tree_map(lambda a, b: bool(np.any(np.asarray(a) != np.asarray(b))),
                                   j_params, params)
    assert all(jax.tree_util.tree_leaves(moved))
    assert_state_close(state, j_state, atol=1e-5)
    assert not np.array_equal(state.mem.numpy(), st["mem"])  # the flush wrote rows


def run_jax_eval(src, dst, t, edge_x, cands, params, st):
    data = JDGData.from_raw(t, np.stack([src, dst], 1), edge_x)
    _, val, test = data.split()
    dgs = {"val": JDGraph(val), "test": JDGraph(test)}
    hm = JHookManager(keys=["val", "test"])
    for split in ("val", "test"):
        hm.register(split, JTGB(candidates=cands[split]))
    rec = JRecency(N, [K], *KEYS, edge_dim=EDGE_DIM, edge_x_full=data.edge_x)
    hm.register_shared(rec)
    hm.register_shared(JDedup(N, seed_nodes_keys=DEDUP_KEYS))
    memory, encoder, decoder = jax_modules()
    _, eval_core = j_build_cores(memory, encoder, decoder, None, N, style="segment")
    carry = (params, to_jax_state(st))
    sums, neg_times = [], []
    for split in ("val", "test"):
        stream = JStream(dgs[split], BSIZE)
        fn, states = hm.as_transform(split, dgs[split])

        @jax.jit
        def step(states, carry, i):
            states, batch = fn(states, stream.batch_at(i))
            carry, (s, c) = eval_core(carry, batch)
            return states, carry, s, batch.neg_time

        for i in range(stream.num_batches):
            states, carry, s, nt = step(states, carry, i)
            sums.append(float(s))
            neg_times.append(np.asarray(nt))
        hm.adopt_states(split, states)
    return carry[1], rec.state, sums, neg_times


def run_port_eval(src, dst, t, edge_x, cands, params, st, neg_times):
    data = DGData.from_raw(t, np.stack([src, dst], 1), edge_x)
    _, val, test = data.split()
    dgs = {"val": DGraph(val), "test": DGraph(test)}
    injected = iter(neg_times)
    hm = HookManager(keys=["val", "test"])
    for split in ("val", "test"):
        tgb = TGBNegativeEdgeSamplerHook(cands[split], device="cpu")
        tgb.draw_neg_time = lambda n, lo, hi: torch.from_numpy(next(injected).copy())
        hm.register(split, tgb)
    rec = RecencyNeighborHook(N, [K], *KEYS, edge_dim=EDGE_DIM, edge_x_full=data.edge_x,
                              device="cpu")
    hm.register_shared(rec)
    hm.register_shared(DeduplicationHook(N, seed_nodes_keys=DEDUP_KEYS))
    mods = port_modules()
    load_tgn_params(params, *mods)
    _, eval_core = build_tgn_hook_cores(*mods, None, N, style="segment")
    mem_state, sums = to_port_state(st), []
    for split in ("val", "test"):
        stream = DeviceEdgeStream(dgs[split], BSIZE, device="cpu")
        epoch, states = hook_epoch(stream, hm, split, dgs[split], eval_core)
        mem_state, states, (s, c) = epoch(mem_state, states)
        hm.adopt_states(split, states)
        sums += s.tolist()
    assert next(injected, None) is None
    return mem_state, rec.state, sums


@pytest.mark.parametrize("popularity", ["uniform", "zipf"])
def test_segment_eval_core_matches_jax(popularity):
    src, dst, t, edge_x, rng, pop = make_stream(popularity)
    data = DGData.from_raw(t, np.stack([src, dst], 1), edge_x)
    _, val, test = data.split()
    cands = {"val": rng.choice(N, (val.num_edge_events, Q), p=pop),
             "test": rng.choice(N, (test.num_edge_events, Q), p=pop)}
    st = random_state(rng, int(t.max()))
    params = jax_params(*jax_modules())
    j_mem, j_rec, j_sums, neg_times = run_jax_eval(src, dst, t, edge_x, cands, params, st)
    mem, rec, sums = run_port_eval(src, dst, t, edge_x, cands, params, st, neg_times)
    print(f"{popularity}: MRR sums port {np.round(sums, 5).tolist()} JAX "
          f"{np.round(j_sums, 5).tolist()}")
    assert len(sums) == len(j_sums) >= 4
    np.testing.assert_allclose(sums, j_sums, rtol=0, atol=1e-5)
    for got, want in zip(rec, j_rec):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert_state_close(mem, j_mem, atol=1e-5)


# ---------------------------------------------------------------------- #
# TGNPipeline(rowwise=False)
# ---------------------------------------------------------------------- #
PN, PE, PD, PB, PMEM, PEMB, PTIME, PK = 40, 330, 6, 64, 8, 8, 6, 5
PIPE_STEPS = 8  # two passes over the 4 train batches, state reset between


def pipe_stream(seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, PN, PE)
    dst = rng.integers(0, PN, PE)
    dst = np.where(dst == src, (dst + 1) % PN, dst)
    t = np.sort(rng.integers(0, 3000, PE))
    return src, dst, t, rng.normal(size=(PE, PD)).astype(np.float32)


def pipe_snapshot(carry):
    return ([np.array(x) for x in carry.rec_state],
            {n: np.array(getattr(carry.mem_state, n)) for n in STATE_FIELDS})


def test_segment_pipeline_train_steps_match_jax():
    src, dst, t, edge_x = pipe_stream()
    jdata = JDGData.from_raw(t, np.stack([src, dst], 1), edge_x)
    jstream = JStream(JDGraph(jdata.split()[0]), PB)
    jpipe = JPipeline(num_nodes=PN, edge_dim=PD, memory_dim=PMEM, embed_dim=PEMB,
                      time_dim=PTIME, num_nbrs=PK, lr=1e-3, neg_low=0, neg_high=PN,
                      rowwise=False, edge_x_full=jnp.asarray(jdata.edge_x))
    carry = jpipe.init_carry(jax.random.PRNGKey(3))
    params = carry.params
    negs, key = [], carry.rng
    for _ in range(PIPE_STEPS):
        key, k_neg = jax.random.split(key)
        negs.append(np.asarray(jax.random.randint(k_neg, (PB,), 0, PN, dtype=jnp.int32)))
    step = jax.jit(lambda c, i: jpipe.train_step(c, jstream.batch_at(i)))
    j_losses = []
    n_b = jstream.num_batches
    for s in range(PIPE_STEPS):
        if s % n_b == 0:
            carry = carry._replace(mem_state=j_tgn_init_state(PN, PMEM, PD),
                                   rec_state=j_recency_eid_init(PN, PK))
        carry, loss = step(carry, s % n_b)
        j_losses.append(float(loss))
    j_fwd = np.asarray(jax.jit(lambda c: jpipe.forward_only(c, jstream.batch_at(1)))(carry))
    j_rec, j_mem = pipe_snapshot(carry)

    data = DGData.from_raw(t, np.stack([src, dst], 1), edge_x)
    stream = DeviceEdgeStream(DGraph(data.split()[0]), PB, device="cpu")
    assert stream.num_batches == jstream.num_batches == 4 and stream.num_edges % PB
    pipe = TGNPipeline(PN, PD, PMEM, PEMB, PTIME, PK, 1e-3, 0, PN, rowwise=False,
                       edge_x_full=data.edge_x, device="cpu")
    injected = iter(negs)
    pipe.draw_neg = lambda rng, size: torch.from_numpy(next(injected).copy())
    pc = pipe.init_carry(0, params=params)
    assert isinstance(pc.params["enc"], GraphAttentionEmbedding)
    losses = []
    for s in range(PIPE_STEPS):
        if s % n_b == 0:
            pc = pc._replace(mem_state=tgn_init_state(PN, PMEM, PD, "cpu"),
                             rec_state=recency_eid_init(PN, PK, "cpu"))
        pc, loss = pipe.train_step(pc, stream.batch_at(s % n_b))
        losses.append(float(loss))
    diff = np.abs(np.subtract(losses, j_losses))
    print(f"segment pipeline: {diff.size} steps, max loss diff {diff.max():.3g}")
    assert diff.max() <= 1e-5
    rec, mem = pipe_snapshot(pc)
    for a, b in zip(rec, j_rec):
        np.testing.assert_array_equal(a, b)
    for name in STATE_FIELDS:
        if name in INT_FIELDS:
            np.testing.assert_array_equal(mem[name], j_mem[name], err_msg=name)
        else:
            np.testing.assert_allclose(mem[name], j_mem[name], rtol=0, atol=1e-4, err_msg=name)
    assert np.abs(mem["mem"]).max() > 0.1
    fwd = pipe.forward_only(pc, stream.batch_at(1)).numpy()
    np.testing.assert_allclose(fwd, j_fwd, rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="rowwise"):
        pipe.eval_step(pc, stream.batch_at(0), torch.zeros((PB, 2), dtype=torch.int32))
