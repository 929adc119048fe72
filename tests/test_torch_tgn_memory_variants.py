"""The TGN memory variants of the port against the JAX package on the CPU.

* ``TGNMemory(aggregator="mean")``: ``tgn_mean_store_messages`` over a
  stream of batches (repeated nodes, time ties, padded rows, a node with
  more messages in one batch than ``mean_slots``) exact against JAX after
  every batch, ``overflow`` included; ``stage`` (``_staged_mean``) within
  1e-6 of JAX's, ``flush`` and ``flush_all`` with integer fields exact and
  memory within 1e-6.
* The packed state: ``tgn_pack_state`` and ``tgn_unpack_state`` exact
  against JAX's; ``tgn_store_messages_packed`` exact against JAX's and
  against the unpacked store; ``stage`` / ``flush`` / ``flush_all`` on the
  packed layout equal the unpacked ones.
* ``TGNPipeline(packed_state=True)``: train and eval steps against the JAX
  packed pipeline (its negatives injected; losses within 1e-5, MRR sums
  within 1e-5, state exact or within 1e-4) and against the port's unpacked
  pipeline (bit for bit); the packed carry round-trips through
  ``train/checkpoint.py``.
* ``LearnableSumMerge`` (weights loaded from flax), ``MeanEmbdPooling`` and
  ``SumEmbdPooling`` within 1e-6 of JAX's.

Sizes: 30 nodes, batches of 24 events, 5-dim raw messages, memory and time
dims 8 and 6, 3 mean slots; the pipelines 40 nodes, 231 train edges (batch
64) and 49 val edges (batch 32, 4 candidates), dims 8/6/8, K = 5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgm_tpu import DGData as JDGData
from tgm_tpu import DGraph as JDGraph
from tgm_tpu.nn.encoder import tgn as jtgn
from tgm_tpu.nn.modules import aggregation as jagg
from tgm_tpu.train import DeviceEdgeStream as JStream
from tgm_tpu.train import TGNPipeline as JPipeline
from tgm_tpu_torch import DGData, DGraph
from tgm_tpu_torch.nn import (
    LearnableSumMerge,
    MeanEmbdPooling,
    SumEmbdPooling,
    TGNMeanMemoryState,
    TGNMemory,
    TGNMemoryState,
    TGNPackedState,
    tgn_mean_init_state,
    tgn_mean_store_messages,
    tgn_pack_state,
    tgn_store_messages,
    tgn_store_messages_packed,
    tgn_unpack_state,
)
from tgm_tpu_torch.train import DeviceEdgeStream, TGNPipeline, restore_checkpoint, save_checkpoint
from tgm_tpu_torch.weights import load_learnable_sum_merge, load_tgn_memory_params

N, B, R, MEM, TIME, SLOTS = 30, 24, 5, 8, 6, 3
LAST_FIELDS = ("mem", "last_update", "s_other", "s_t", "s_raw", "s_valid",
               "d_other", "d_t", "d_raw", "d_valid")


def event_batches(seed, n_batches=5):
    """Batches of (src, dst, t, raw, valid): node 0 is the src of 6 events of
    batch 1 (past the 3 slots), times tie, the last 4 rows of batch 3 are padding."""
    rng = np.random.default_rng(seed)
    out, t0 = [], 0
    for b in range(n_batches):
        src = rng.integers(0, N, B).astype(np.int32)
        dst = rng.integers(0, N, B).astype(np.int32)
        if b == 1:
            src[:6] = 0
        t = (t0 + np.sort(rng.integers(0, 20, B))).astype(np.int32)
        t0 = int(t[-1])
        raw = rng.normal(size=(B, R)).astype(np.float32)
        valid = np.ones(B, bool)
        if b == 3:
            valid[-4:] = False
            src[-4:], dst[-4:], t[-4:] = -1, -1, 0
        out.append((src, dst, t, raw, valid))
    return out


def j_args(ev):
    return [jnp.asarray(x) for x in ev]


def t_args(ev):
    return [torch.from_numpy(x.copy()) for x in ev]


def assert_fields(got, want, fields, atol=0.0):
    for name in fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        g = g.detach().numpy()
        if np.issubdtype(w.dtype, np.floating) and atol:
            np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def jax_memory(aggregator="last"):
    return jtgn.TGNMemory(num_nodes=N, raw_msg_dim=R, memory_dim=MEM, time_dim=TIME,
                          aggregator=aggregator, mean_slots=SLOTS)


def port_memory(params, aggregator="last"):
    """A port ``TGNMemory`` with the flax memory's parameters."""
    mem = TGNMemory(N, R, MEM, TIME, aggregator=aggregator, mean_slots=SLOTS)
    load_tgn_memory_params(params, mem)
    return mem


def perturbed_mem_params(memory, state):
    p = memory.init(jax.random.PRNGKey(0), state, jnp.zeros(4, jnp.int32))
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + rng.normal(scale=0.05, size=a.shape)
                              .astype(np.float32)), p)


def mean_states_through(events):
    """JAX and port mean states after each batch, from fresh, with a random memory."""
    rng = np.random.default_rng(9)
    mem0 = rng.normal(size=(N + 1, MEM)).astype(np.float32)
    mem0[N] = 0
    js = jtgn.tgn_mean_init_state(N, MEM, R, SLOTS)._replace(mem=jnp.asarray(mem0))
    ps = tgn_mean_init_state(N, MEM, R, SLOTS, "cpu")
    ps.mem.copy_(torch.from_numpy(mem0))
    return js, ps


# ---------------------------------------------------------------------- #
# The mean aggregator
# ---------------------------------------------------------------------- #
def test_mean_store_matches_jax_exactly():
    events = event_batches(1)
    js, ps = mean_states_through(events)
    store = jax.jit(jtgn.tgn_mean_store_messages)
    for b, ev in enumerate(events):
        js = store(js, *j_args(ev))
        ps = tgn_mean_store_messages(ps, *t_args(ev))
        assert_fields(ps, js, TGNMeanMemoryState._fields)
    assert int(ps.counter) == len(events)
    assert int(ps.overflow) == int(js.overflow) >= 3  # node 0's 6 messages over 3 slots
    assert (ps.s_stamp.numpy() > 0).any() and (ps.s_wp.numpy() > 0).any()


def test_mean_stage_flush_and_flush_all_match_jax():
    events = event_batches(2)
    js, ps = mean_states_through(events)
    for ev in events[:3]:
        js = jtgn.tgn_mean_store_messages(js, *j_args(ev))
        ps = tgn_mean_store_messages(ps, *t_args(ev))
    jmem = jax_memory("mean")
    p = perturbed_mem_params(jmem, js)
    mem = port_memory(p, "mean")
    nids = np.array([0, 1, 5, 29, -1, N, N + 3, 0, 7], np.int32)
    w_mem, w_last = jax.jit(lambda s, n: jmem.apply(p, s, n, method=jtgn.TGNMemory.stage))(
        js, jnp.asarray(nids))
    g_mem, g_last = mem.stage(ps, torch.from_numpy(nids))
    np.testing.assert_allclose(g_mem.detach().numpy(), np.asarray(w_mem), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(g_last.numpy(), np.asarray(w_last))
    assert (g_last.numpy() > 0).any()

    flushed = jax.jit(lambda s, n: jmem.apply(p, s, n, method=jtgn.TGNMemory.flush))(
        js, jnp.asarray(nids))
    ps = mem.flush(ps, torch.from_numpy(nids))
    assert_fields(ps, flushed, TGNMeanMemoryState._fields, atol=1e-6)
    ev = events[3]
    flushed = jtgn.tgn_mean_store_messages(flushed, *j_args(ev))
    ps = mem.store(ps, *t_args(ev))
    js_all = jax.jit(lambda s: jmem.apply(p, s, method=jtgn.TGNMemory.flush_all))(flushed)
    ps = mem.flush_all(ps)
    assert_fields(ps, js_all, TGNMeanMemoryState._fields, atol=1e-6)
    assert int(ps.s_latest.abs().sum()) == int(ps.d_latest.abs().sum()) == 0
    assert isinstance(mem.init_state("cpu"), TGNMeanMemoryState)
    with pytest.raises(ValueError, match="aggregator"):
        TGNMemory(N, R, MEM, TIME, aggregator="max")


# ---------------------------------------------------------------------- #
# The packed state
# ---------------------------------------------------------------------- #
def random_last_state(seed):
    rng = np.random.default_rng(seed)
    n1 = N + 1
    last = rng.integers(0, 50, n1).astype(np.int32)
    st = dict(mem=rng.normal(size=(n1, MEM)).astype(np.float32), last_update=last,
              s_other=rng.integers(-1, N, n1).astype(np.int32),
              s_t=(last + rng.integers(0, 50, n1)).astype(np.int32),
              s_raw=rng.normal(size=(n1, R)).astype(np.float32), s_valid=rng.random(n1) < 0.6,
              d_other=rng.integers(-1, N, n1).astype(np.int32),
              d_t=(last + rng.integers(0, 50, n1)).astype(np.int32),
              d_raw=rng.normal(size=(n1, R)).astype(np.float32), d_valid=rng.random(n1) < 0.6)
    for name, fill in (("mem", 0), ("last_update", 0), ("s_other", -1), ("s_t", 0), ("s_raw", 0),
                       ("s_valid", False), ("d_other", -1), ("d_t", 0), ("d_raw", 0),
                       ("d_valid", False)):
        st[name][N] = fill
    return (jtgn.TGNMemoryState(**{k: jnp.asarray(v) for k, v in st.items()}),
            TGNMemoryState(**{k: torch.from_numpy(v.copy()) for k, v in st.items()}))


def test_pack_and_unpack_match_jax_exactly():
    js, ps = random_last_state(3)
    jp, pp = jtgn.tgn_pack_state(js), tgn_pack_state(ps)
    assert_fields(pp, jp, TGNPackedState._fields)
    assert pp.meta.dtype == torch.int32
    back = tgn_unpack_state(pp)
    assert_fields(back, jtgn.tgn_unpack_state(jp), LAST_FIELDS)
    assert_fields(back, js, LAST_FIELDS)
    assert all(getattr(back, f).is_contiguous() for f in LAST_FIELDS)


def test_packed_store_matches_jax_and_the_unpacked_store():
    js, ps = random_last_state(4)
    jp, pp = jtgn.tgn_pack_state(js), tgn_pack_state(ps)
    store = jax.jit(jtgn.tgn_store_messages_packed)
    for ev in event_batches(5):
        jp = store(jp, *j_args(ev))
        pp = tgn_store_messages_packed(pp, *t_args(ev))
        ps = tgn_store_messages(ps, *t_args(ev))
        assert_fields(pp, jp, TGNPackedState._fields)
        assert_fields(tgn_unpack_state(pp), ps, LAST_FIELDS)


def test_packed_stage_flush_and_flush_all_equal_the_unpacked():
    js, ps = random_last_state(6)
    pp = tgn_pack_state(ps)
    jmem = jax_memory()
    mem = port_memory(perturbed_mem_params(jmem, js))
    nids = torch.tensor([0, 3, 3, 17, -1, N, N + 2, 29], dtype=torch.int32)
    for training in (True, False):
        a, b = mem.stage(ps, nids, training), mem.stage(pp, nids, training)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    ps, pp = mem.flush(ps, nids), mem.flush(pp, nids)
    assert_fields(tgn_unpack_state(pp), ps, LAST_FIELDS)
    ps, pp = mem.flush_all(ps), mem.flush_all_packed(pp)
    assert_fields(tgn_unpack_state(pp), ps, LAST_FIELDS)
    jp = perturbed_mem_params(jmem, js)
    j_all = jax.jit(lambda s: jmem.apply(jp, s, method=jtgn.TGNMemory.flush_all_packed))(
        jtgn.tgn_pack_state(js))
    # Only the clearing is compared with JAX here: the stores and the dump row.
    np.testing.assert_array_equal(pp.meta[:, 1:].numpy(), np.asarray(j_all.meta[:, 1:]))
    assert float(pp.raws.abs().max()) == 0.0


# ---------------------------------------------------------------------- #
# TGNPipeline(packed_state=True)
# ---------------------------------------------------------------------- #
PN, PE, PD, PB, PVB, PMEM, PEMB, PTIME, PK, PQ = 40, 330, 6, 64, 32, 8, 8, 6, 5, 4


def pipe_stream(seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, PN, PE)
    dst = rng.integers(0, PN, PE)
    dst = np.where(dst == src, (dst + 1) % PN, dst)
    t = np.sort(rng.integers(0, 3000, PE))
    edge_x = rng.normal(size=(PE, PD)).astype(np.float32)
    cands = rng.integers(-1, PN, (2, PVB, PQ)).astype(np.int32)
    return src, dst, t, edge_x, cands


def unpacked(carry):
    st = carry.mem_state
    if isinstance(st, (TGNPackedState, jtgn.TGNPackedState)):
        st = tgn_unpack_state(st) if isinstance(st, TGNPackedState) else jtgn.tgn_unpack_state(st)
    return {n: np.array(getattr(st, n)) for n in LAST_FIELDS}


def test_packed_pipeline_matches_jax_and_the_unpacked_pipeline(tmp_path):
    src, dst, t, edge_x, cands = pipe_stream()
    jdata = JDGData.from_raw(t, np.stack([src, dst], 1), edge_x)
    jtrain, jval, _ = jdata.split()
    jts, jvs = JStream(JDGraph(jtrain), PB), JStream(JDGraph(jval), PVB)
    jpipe = JPipeline(num_nodes=PN, edge_dim=PD, memory_dim=PMEM, embed_dim=PEMB,
                      time_dim=PTIME, num_nbrs=PK, lr=1e-3, neg_low=0, neg_high=PN,
                      packed_state=True, edge_x_full=jnp.asarray(jdata.edge_x))
    carry = jpipe.init_carry(jax.random.PRNGKey(5))
    assert isinstance(carry.mem_state, jtgn.TGNPackedState)
    params = carry.params
    negs, key = [], carry.rng
    for _ in range(jts.num_batches):
        key, k_neg = jax.random.split(key)
        negs.append(np.asarray(jax.random.randint(k_neg, (PB,), 0, PN, dtype=jnp.int32)))
    train = jax.jit(lambda c, i: jpipe.train_step(c, jts.batch_at(i)))
    j_losses = []
    for i in range(jts.num_batches):
        carry, loss = train(carry, i)
        j_losses.append(float(loss))
    carry = jax.jit(jpipe.flush_all)(carry)
    ev = jax.jit(lambda c, i, cd: jpipe.eval_step(c, jvs.batch_at(i), cd))
    j_sums = []
    for i in range(jvs.num_batches):
        carry, (s, _) = ev(carry, i, jnp.asarray(cands[i]))
        j_sums.append(float(s))
    j_state = unpacked(carry)

    data = DGData.from_raw(t, np.stack([src, dst], 1), edge_x)
    ptrain, pval, _ = data.split()
    ts = DeviceEdgeStream(DGraph(ptrain), PB, device="cpu")
    vs = DeviceEdgeStream(DGraph(pval), PVB, device="cpu")
    assert ts.num_batches == 4 and vs.num_batches == 2
    runs = {}
    for packed in (True, False):
        pipe = TGNPipeline(PN, PD, PMEM, PEMB, PTIME, PK, 1e-3, 0, PN, packed_state=packed,
                           edge_x_full=data.edge_x, device="cpu")
        injected = iter(negs)
        pipe.draw_neg = lambda rng, size: torch.from_numpy(next(injected).copy())
        pc = pipe.init_carry(0, params=params)
        assert isinstance(pc.mem_state, TGNPackedState) == packed
        losses = []
        for i in range(ts.num_batches):
            pc, loss = pipe.train_step(pc, ts.batch_at(i))
            losses.append(float(loss))
        pc = pipe.flush_all(pc)
        if packed:  # the packed carry round-trips through a checkpoint
            save_checkpoint(str(tmp_path / "ckpt"), pc)
            fresh = TGNPipeline(PN, PD, PMEM, PEMB, PTIME, PK, 1e-3, 0, PN, packed_state=True,
                                edge_x_full=data.edge_x, device="cpu")
            restored = restore_checkpoint(str(tmp_path / "ckpt"), like=fresh.init_carry(1))
            assert isinstance(restored.mem_state, TGNPackedState)
            for a, b in zip(restored.mem_state, pc.mem_state):
                assert torch.equal(a, b)
            for a, b in zip(restored.params.parameters(), pc.params.parameters()):
                assert torch.equal(a, b)
            pc = restored
        sums = []
        for i in range(vs.num_batches):
            pc, (s, _) = pipe.eval_step(pc, vs.batch_at(i), torch.from_numpy(cands[i]))
            sums.append(float(s))
        runs[packed] = (losses, sums, unpacked(pc))
    losses, sums, state = runs[True]
    print(f"packed pipeline: losses {losses} against JAX {j_losses}; MRR sums {sums} against "
          f"{j_sums}")
    np.testing.assert_allclose(losses, j_losses, rtol=0, atol=1e-5)
    np.testing.assert_allclose(sums, j_sums, rtol=0, atol=1e-5)
    for name in LAST_FIELDS:
        if name in ("mem", "s_raw", "d_raw"):
            np.testing.assert_allclose(state[name], j_state[name], rtol=0, atol=1e-4, err_msg=name)
        else:
            np.testing.assert_array_equal(state[name], j_state[name], err_msg=name)
    # The packed layout changes no bit against the unpacked pipeline.
    u_losses, u_sums, u_state = runs[False]
    assert losses == u_losses and sums == u_sums
    for name in LAST_FIELDS:
        np.testing.assert_array_equal(state[name], u_state[name], err_msg=name)


# ---------------------------------------------------------------------- #
# The rest of nn/modules/aggregation.py
# ---------------------------------------------------------------------- #
def test_aggregation_modules_match_jax():
    rng = np.random.default_rng(8)
    z_src = rng.normal(size=(7, 5)).astype(np.float32)
    z_dst = rng.normal(size=(7, 5)).astype(np.float32)
    jm = jagg.LearnableSumMerge(dim=4)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(z_src), jnp.asarray(z_dst))
    merge = LearnableSumMerge(4, in_dim=5)
    load_learnable_sum_merge(v, merge)
    want = jm.apply(v, jnp.asarray(z_src), jnp.asarray(z_dst))
    got = merge(torch.from_numpy(z_src), torch.from_numpy(z_dst))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert merge.out_channels == jm.out_channels == 4

    valid = np.array([True, False, True, True, False, True, True])
    for cls_j, cls_t in ((jagg.MeanEmbdPooling, MeanEmbdPooling),
                         (jagg.SumEmbdPooling, SumEmbdPooling)):
        jp, tp = cls_j(5), cls_t(5)
        assert tp.out_channels == jp.out_channels == 5
        for mask in (None, valid, np.zeros(7, bool)):
            want = jp(jnp.asarray(z_src), None if mask is None else jnp.asarray(mask))
            got = tp(torch.from_numpy(z_src), None if mask is None else torch.from_numpy(mask))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
