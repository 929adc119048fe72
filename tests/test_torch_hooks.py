"""The port's serving hooks against the JAX package's, batch by batch.

* ``RecencyNeighborHook`` (eid layout): a multi-batch stream with time ties
  inside and across batches, a padded tail batch and candidate seeds that
  include PAD, directed and undirected, against the JAX hook with both its
  sorted push plan and its dense one (``neighbors.USE_DENSE_PUSH``). The port
  always runs the dense plan.
* ``TGBNegativeEdgeSamplerHook``: candidates with duplicates and PAD, a
  padded tail batch; the port is fed the JAX hook's ``neg_time`` draws.
* ``seed_lookup`` / ``candidate_rows`` and ``map_to_local``.

Tolerance: exact equality everywhere (integers, and edge features gathered
by id).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgm_tpu.core.batch import DGBatch as JBatch
from tgm_tpu.hooks import RecencyNeighborHook as JRecency
from tgm_tpu.hooks import TGBNegativeEdgeSamplerHook as JTGB
from tgm_tpu.hooks import candidate_rows as j_candidate_rows
from tgm_tpu.hooks import map_to_local as j_map_to_local
from tgm_tpu.hooks import neighbors as j_neighbors
from tgm_tpu.hooks import seed_lookup as j_seed_lookup
from tgm_tpu_torch.core.batch import DGBatch
from tgm_tpu_torch.hooks import (
    RecencyNeighborHook,
    TGBNegativeEdgeSamplerHook,
    candidate_rows,
    map_to_local,
    seed_lookup,
)

N, K, BSIZE, N_BATCHES, EDGE_DIM, N_NEG = 25, 4, 16, 6, 3, 12


def event_stream(seed):
    """Chronological edges in fixed-width batches; the last one half padded."""
    rng = np.random.default_rng(seed)
    E = BSIZE * N_BATCHES
    src = rng.integers(0, N - 3, E).astype(np.int32)  # nodes N-3.. stay empty
    dst = rng.integers(0, N - 3, E).astype(np.int32)
    t = np.sort(rng.integers(0, 40, E)).astype(np.int32)  # ties in and across batches
    valid = np.ones(E, bool)
    valid[-BSIZE // 2:] = False
    src[~valid], dst[~valid], t[~valid] = -1, -1, 0
    eids = np.where(valid, np.arange(E), -1).astype(np.int32)
    edge_x = rng.normal(size=(E, EDGE_DIM)).astype(np.float32)
    neg = rng.integers(-1, N + 2, (N_BATCHES, N_NEG)).astype(np.int32)  # PAD and invalid ids
    neg_t = rng.integers(0, 45, (N_BATCHES, N_NEG)).astype(np.int32)
    return src, dst, t, valid, eids, edge_x, neg, neg_t


@pytest.mark.parametrize("dense_push", [True, False])
@pytest.mark.parametrize("directed", [False, True])
def test_recency_hook_stream_matches_jax(monkeypatch, dense_push, directed):
    monkeypatch.setattr(j_neighbors, "USE_DENSE_PUSH", dense_push)
    src, dst, t, valid, eids, edge_x, neg, neg_t = event_stream(seed=3 + directed)
    keys = (["edge_src", "edge_dst", "neg"], ["edge_time", "edge_time", "neg_time"])
    j_hook = JRecency(N, [K], *keys, directed=directed, edge_dim=EDGE_DIM, edge_x_full=edge_x)
    hook = RecencyNeighborHook(N, [K], *keys, directed=directed, edge_dim=EDGE_DIM,
                               edge_x_full=edge_x, device="cpu")
    j_apply = jax.jit(j_hook.apply)
    j_state, state = j_hook.init_state(None), hook.init_state(None)
    for b in range(N_BATCHES):
        sl = slice(b * BSIZE, (b + 1) * BSIZE)
        jb = JBatch(jnp.asarray(src[sl]), jnp.asarray(dst[sl]), jnp.asarray(t[sl]),
                    jnp.asarray(valid[sl]))
        jb.edge_ids, jb.neg, jb.neg_time = (jnp.asarray(x) for x in (eids[sl], neg[b], neg_t[b]))
        pb = DGBatch(*(torch.from_numpy(x[sl].copy()) for x in (src, dst, t, valid)),
                     edge_ids=torch.from_numpy(eids[sl].copy()),
                     neg=torch.from_numpy(neg[b].copy()), neg_time=torch.from_numpy(neg_t[b].copy()))
        j_state, jb = j_apply(j_state, jb)
        state, pb = hook.apply(state, pb)
        for name in ("seed_nids", "seed_times", "nbr_nids", "nbr_edge_time", "nbr_edge_x"):
            np.testing.assert_array_equal(getattr(pb, name)[0].numpy(),
                                          np.asarray(getattr(jb, name)[0]), err_msg=f"{name} @ {b}")
        for got, want in zip(state, j_state):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"state @ {b}")
    # The stream filled some rows past B pushes and left others empty.
    wp = state[3].numpy()
    assert (wp[: N - 3] > K).any() and (wp[N - 3: N] == 0).all() and wp[N] == 0


def test_recency_hook_rejects_unported_layouts():
    edge_x = np.zeros((4, 2), np.float32)
    keys = (["edge_src"], ["edge_time"])
    # The packed layout is ported and, as in JAX, needs the eid layout.
    with pytest.raises(ValueError, match="edge_x_full"):
        RecencyNeighborHook(N, [K], *keys, packed_buffers=True, device="cpu")
    packed = RecencyNeighborHook(N, [K], *keys, edge_x_full=edge_x, packed_buffers=True,
                                 device="cpu")
    assert packed.init_state()[0].shape == (N + 1, K, 3)
    # Multi-hop queries are ported: the hook builds, its rings hold max(num_nbrs) slots.
    hook = RecencyNeighborHook(N, [2, K], *keys, edge_x_full=edge_x, device="cpu")
    assert hook.num_nbrs == [2, K] and hook.init_state()[0].shape == (N + 1, K)


def test_tgb_hook_matches_jax():
    rng = np.random.default_rng(5)
    Q, n_edges = 4, 3 * BSIZE - 5  # the candidate rows run out inside the last batch
    cands = rng.integers(0, 9, (n_edges, Q)).astype(np.int32)  # many duplicates
    cands[rng.random((n_edges, Q)) < 0.1] = -1
    j_hook, hook = JTGB(candidates=cands), TGBNegativeEdgeSamplerHook(cands, device="cpu")
    j_apply = jax.jit(j_hook.apply)
    j_state, state = j_hook.init_state(None), hook.init_state(None)
    t = np.sort(rng.integers(100, 200, 3 * BSIZE)).astype(np.int32)
    for b in range(3):
        sl = slice(b * BSIZE, (b + 1) * BSIZE)
        valid = np.arange(sl.start, sl.stop) < n_edges
        src = np.where(valid, rng.integers(0, 9, BSIZE), -1).astype(np.int32)
        tb = np.where(valid, t[sl], 0).astype(np.int32)
        jb = JBatch(jnp.asarray(src), jnp.asarray(src), jnp.asarray(tb), jnp.asarray(valid))
        j_state, jb = j_apply(j_state, jb)
        drawn = np.asarray(jb.neg_time)
        hook.draw_neg_time = lambda n, lo, hi: torch.from_numpy(drawn.copy())
        pb = DGBatch(*(torch.from_numpy(x) for x in (src, src, tb, valid)))
        state, pb = hook.apply(state, pb)
        for name in ("neg", "neg_batch_list", "neg_valid", "neg_time"):
            np.testing.assert_array_equal(getattr(pb, name).numpy(), np.asarray(getattr(jb, name)),
                                          err_msg=f"{name} @ {b}")
        assert pb.neg.shape == (BSIZE * Q,)  # the B*Q padding keeps the seed layout
        assert int(state) == int(j_state[1])
    assert int(state) == n_edges


def test_tgb_hook_draw_stays_in_batch_range():
    hook = TGBNegativeEdgeSamplerHook(np.arange(40).reshape(10, 4), device="cpu", seed=3)
    state = hook.init_state(None)
    valid = torch.tensor([True] * 6 + [False] * 2)
    t = torch.tensor([5, 5, 7, 9, 9, 12, 0, 0], dtype=torch.int32)
    batch = DGBatch(torch.arange(8, dtype=torch.int32), torch.arange(8, dtype=torch.int32), t, valid)
    state, batch = hook.apply(state, batch)
    live = batch.neg != -1
    assert int(live.sum()) == 24 and int(state) == 6
    assert ((batch.neg_time[live] >= 5) & (batch.neg_time[live] <= 12)).all()
    assert (batch.neg_time[~live] == 0).all()


def test_seed_lookup_candidate_rows_map_to_local_match_jax():
    rng = np.random.default_rng(11)
    n = 30
    seeds = rng.integers(-2, n + 3, 50).astype(np.int32)  # duplicates, PAD, out of range
    cands = rng.integers(-1, n + 2, (7, 5)).astype(np.int32)
    lut = seed_lookup(torch.from_numpy(seeds), n)
    j_lut = j_seed_lookup(jnp.asarray(seeds), n)
    np.testing.assert_array_equal(lut.numpy(), np.asarray(j_lut))
    rows, found = candidate_rows(lut, torch.from_numpy(cands), len(seeds))
    j_rows, j_found = j_candidate_rows(j_lut, jnp.asarray(cands), len(seeds))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(j_rows))
    np.testing.assert_array_equal(found.numpy(), np.asarray(j_found))
    g2l = rng.integers(0, 9, n + 1).astype(np.int32)
    np.testing.assert_array_equal(map_to_local(torch.from_numpy(g2l), torch.from_numpy(seeds)).numpy(),
                                  np.asarray(j_map_to_local(jnp.asarray(g2l), jnp.asarray(seeds))))
