"""The packed recency layout against the JAX package and the eid layout.

A chronological stream made with numpy from a seed (40 nodes, 330 edges,
6-dim features, batches of 64 with a partial tail; ties inside batches).

* ``recency_pk_init`` / ``_query`` / ``_update`` against JAX's batch by
  batch: the (N+1, B, 3) buffer, the write positions and the query
  products exact (JAX's CPU query is its jnp select, which agrees with the
  rank rule of K1 on a chronological stream, ROADMAP.md fault 1).
* ``RecencyNeighborHook(packed_buffers=True)``, two hops: products equal to
  the eid layout's and to JAX's packed hook, the packed planes equal to the
  eid layout's three buffers after every batch.
* ``TGNPipeline(packed_recency=True)``: train losses and eval sums equal to
  the eid layout's bit for bit (the same selections feed the same math),
  the planes equal to its buffers; and one train epoch against the JAX
  pipeline with ``packed_recency=True`` and its negatives injected: losses
  within 1e-5, recency state exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgm_tpu import DGData as JDGData
from tgm_tpu import DGraph as JDGraph
from tgm_tpu.hooks import RecencyNeighborHook as JRecency
from tgm_tpu.hooks.neighbors import recency_pk_init as j_pk_init
from tgm_tpu.hooks.neighbors import recency_pk_query as j_pk_query
from tgm_tpu.hooks.neighbors import recency_pk_update as j_pk_update
from tgm_tpu.train import DeviceEdgeStream as JStream
from tgm_tpu.train import TGNPipeline as JPipeline
from tgm_tpu.train import jit_scan_epoch as j_jit_scan_epoch
from tgm_tpu_torch import DGData, DGraph
from tgm_tpu_torch.hooks import RecencyNeighborHook
from tgm_tpu_torch.hooks.neighbors import recency_pk_init, recency_pk_query, recency_pk_update
from tgm_tpu_torch.train import DeviceEdgeStream, TGNPipeline, jit_scan_epoch

N, E, D, B, K, MEM, EMB, TIME, Q, LR = 40, 330, 6, 64, 5, 8, 8, 6, 5, 1e-3


def make_stream(seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E)
    dst = rng.integers(0, N, E)
    dst = np.where(dst == src, (dst + 1) % N, dst)
    t = np.sort(rng.integers(0, 2 * E, E))  # repeated times: ties inside batches
    edge_x = rng.normal(size=(E, D)).astype(np.float32)
    return src, dst, t, edge_x, rng


def streams(seed=0):
    src, dst, t, edge_x, rng = make_stream(seed)
    idx = np.stack([src, dst], 1)
    jd, pd = JDGData.from_raw(t, idx, edge_x), DGData.from_raw(t, idx, edge_x)
    return (jd, JStream(JDGraph(jd), B), pd, DeviceEdgeStream(DGraph(pd), B, device="cpu"),
            rng)


@pytest.mark.parametrize("directed", [False, True], ids=["undirected", "directed"])
def test_pk_functions_match_jax_batch_by_batch(directed):
    jd, js, pd, ps, rng = streams(1)
    j_state, p_state = j_pk_init(N, K), recency_pk_init(N, K, "cpu")
    for a, b in zip(p_state, j_state):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    query, update = jax.jit(j_pk_query, static_argnums=3), jax.jit(j_pk_update,
                                                                   static_argnums=6)
    filled = 0
    for i in range(ps.num_batches):
        jb, pb = js.batch_at(i), ps.batch_at(i)
        seeds = np.concatenate([rng.integers(-1, N + 1, 30), np.asarray(pb.edge_src)])
        seeds = seeds.astype(np.int32)
        times = np.concatenate([rng.integers(0, 2 * E, 30), np.asarray(pb.edge_time)])
        times = times.astype(np.int32)
        want = query(j_state, jnp.asarray(seeds), jnp.asarray(times), K)
        got = recency_pk_query(p_state, torch.from_numpy(seeds), torch.from_numpy(times), K)
        for name, a, b in zip(("ids", "times", "eids"), got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{name} @ {i}")
        filled += int((got[0] >= 0).sum())
        j_state = update(j_state, jb.edge_src, jb.edge_dst, jb.edge_time, jb.edge_ids,
                         jb.edge_valid, directed)
        p_state = recency_pk_update(p_state, pb.edge_src, pb.edge_dst, pb.edge_time,
                                    pb.edge_ids, pb.edge_valid, directed)
        for name, a, b in zip(("buf", "write_pos"), p_state, j_state):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{name} @ {i}")
        np.testing.assert_array_equal(p_state[0][N].numpy(), [[-1, 0, -1]] * K)
        assert int(p_state[1][N]) == 0
    assert filled > 100 and (p_state[1][:N] > K).any()


def hook_kwargs(data):
    return dict(num_nodes=N, num_nbrs=[4, 3], seed_nodes_keys=["edge_src", "edge_dst"],
                seed_times_keys=["edge_time", "edge_time"], edge_x_full=data.edge_x)


def test_packed_hook_matches_the_eid_layout_and_jax():
    jd, js, pd, ps, _ = streams(2)
    packed = RecencyNeighborHook(**hook_kwargs(pd), packed_buffers=True, device="cpu")
    eid = RecencyNeighborHook(**hook_kwargs(pd), device="cpu")
    jhook = JRecency(**hook_kwargs(jd), packed_buffers=True)
    pk_state, eid_state, j_state = packed.init_state(), eid.init_state(), jhook.init_state()
    japply = jax.jit(jhook.apply)
    names = ("seed_nids", "seed_times", "nbr_nids", "nbr_edge_time", "nbr_edge_x")
    for i in range(ps.num_batches):
        pk_state, pb = packed.apply(pk_state, ps.batch_at(i))
        eid_state, eb = eid.apply(eid_state, ps.batch_at(i))
        j_state, jb = japply(j_state, js.batch_at(i))
        for name in names:
            for hop, (a, b, c) in enumerate(zip(getattr(pb, name), getattr(eb, name),
                                                getattr(jb, name))):
                assert torch.equal(a, b), f"{name}[{hop}] @ {i}: packed vs eid"
                np.testing.assert_array_equal(a.numpy(), np.asarray(c),
                                              err_msg=f"{name}[{hop}] @ {i}: port vs JAX")
        buf, wp = pk_state
        for c in range(3):
            assert torch.equal(buf[:, :, c], eid_state[c]), f"plane {c} @ {i}"
        assert torch.equal(wp, eid_state[3])
        for a, b in zip(pk_state, j_state):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"state @ {i}")


def test_packed_hook_needs_the_eid_layout():
    with pytest.raises(ValueError, match="edge_x_full"):
        RecencyNeighborHook(N, [K], ["edge_src"], ["edge_time"], packed_buffers=True,
                            device="cpu")


def make_pipe(edge_x_full, negs, packed):
    pipe = TGNPipeline(N, D, MEM, EMB, TIME, K, LR, 0, N, edge_x_full=edge_x_full,
                       packed_recency=packed, device="cpu")
    injected = iter(negs)
    pipe.draw_neg = lambda rng, size: torch.from_numpy(next(injected).copy())
    return pipe


def test_pipeline_packed_recency_matches_the_eid_layout_and_jax():
    jd, js, pd, ps, rng = streams(3)
    jpipe = JPipeline(num_nodes=N, edge_dim=D, memory_dim=MEM, embed_dim=EMB, time_dim=TIME,
                      num_nbrs=K, lr=LR, neg_low=0, neg_high=N,
                      edge_x_full=jnp.asarray(jd.edge_x), packed_recency=True)
    jcarry = jpipe.init_carry(jax.random.PRNGKey(7))
    params = jax.tree_util.tree_map(np.asarray, jcarry.params)
    negs, key = [], jcarry.rng
    for _ in range(js.num_batches):  # the negatives train_step draws
        key, k_neg = jax.random.split(key)
        negs.append(np.asarray(jax.random.randint(k_neg, (B,), 0, N, dtype=jnp.int32)))
    jcarry, j_losses = j_jit_scan_epoch(jpipe.train_step, js.batch_at, js.num_batches,
                                        donate_carry=False)(jcarry)

    cands = torch.from_numpy(rng.integers(-1, N, (B, Q)).astype(np.int32))
    runs = {}
    for packed in (True, False):
        pipe = make_pipe(pd.edge_x, negs, packed)
        carry = pipe.init_carry(0, params=params)
        carry, losses = jit_scan_epoch(pipe.train_step, ps.batch_at, ps.num_batches)(carry)
        carry = pipe.flush_all(carry)
        evals = []
        for i in range(2):  # the train stream's first batches again: eval advances the state
            carry, (s, c) = pipe.eval_step(carry, ps.batch_at(i), cands)
            evals.append((float(s), float(c)))
        runs[packed] = (losses, carry.rec_state, evals)
    (pk_losses, pk_state, pk_evals), (eid_losses, eid_state, eid_evals) = runs[True], runs[False]
    assert torch.equal(pk_losses, eid_losses) and pk_evals == eid_evals
    for c in range(3):
        assert torch.equal(pk_state[0][:, :, c], eid_state[c])
    assert torch.equal(pk_state[1], eid_state[3])

    gap = np.abs(pk_losses.numpy() - np.asarray(j_losses)).max()
    print(f"packed pipeline: {ps.num_batches} train steps, max loss gap to JAX {gap:.3g}")
    assert gap <= 1e-5
    # The JAX carry after the epoch; the port's after the epoch and 2 eval batches.
    pipe = make_pipe(pd.edge_x, negs, True)
    carry, _ = jit_scan_epoch(pipe.train_step, ps.batch_at, ps.num_batches)(
        pipe.init_carry(0, params=params))
    for a, b in zip(carry.rec_state, jcarry.rec_state):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
