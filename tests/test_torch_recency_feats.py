"""The feature-buffer recency layout against the JAX package: K4's plain
versions, the feature push and the feature-layout hook.

* K4's plain version against the Pallas ``recency_window_select`` in
  interpret mode, on random ring rows whose times are not chronological,
  with PAD slots, empty rows and write positions past B.
* The in-place entry's plain version (``recency_feats_select_plain``)
  against the Pallas kernel in interpret mode on the rows JAX gathered from
  the same state (random rows, invalid seeds -1, N and N + 7, K < B and K =
  B, D = 0, 5 and 172), and against JAX ``recency_query`` on chronological
  states that JAX ``recency_update`` pushes built; its wrapper's CPU
  dispatch and checks.
* The feature push (``recency_update``) and ``RecencyNeighborHook`` without
  ``edge_x_full`` over a multi-batch stream with time ties and a padded tail
  batch, against the JAX ``recency_update`` and hook (sorted and dense push
  plans). The JAX hook's query takes its jnp path on the CPU, which equals
  the rank rule on the chronological rows a stream leaves.

Tolerance: exact equality everywhere (integers, and fp32 features copied
bit for bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgm_tpu.core.batch import DGBatch as JBatch
from tgm_tpu.hooks import RecencyNeighborHook as JRecency
from tgm_tpu.hooks import neighbors as j_neighbors
from tgm_tpu.ops.pallas.recency_select import recency_window_select as pallas_select
from tgm_tpu_torch.core.batch import DGBatch
from tgm_tpu_torch.hooks import RecencyNeighborHook
from tgm_tpu_torch.hooks.neighbors import recency_init, recency_query, recency_update
from tgm_tpu_torch.ops import (
    recency_feats_select,
    recency_feats_select_plain,
    recency_window_select,
    recency_window_select_plain,
)

N, K, BSIZE, N_BATCHES, EDGE_DIM, N_NEG = 25, 4, 16, 6, 5, 12


def random_rows(seed, S=70, B=8, D=6):
    """Ring rows in no time order: PAD slots, empty rows, wp past B, ties."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, 9, (S, B)).astype(np.int32)
    ids[rng.random(S) < 0.1] = -1  # empty rows
    times = rng.integers(0, 30, (S, B)).astype(np.int32)
    feats = rng.normal(size=(S, B, D)).astype(np.float32)
    wp = rng.integers(0, 5 * B, S).astype(np.int32)
    qt = rng.integers(0, 35, S).astype(np.int32)
    return ids, times, feats, wp, qt


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_pallas_interpret(seed, k):
    args = random_rows(seed)
    want = pallas_select(*(jnp.asarray(a) for a in args), k=k, block=16, interpret=True)
    got = recency_window_select_plain(*(torch.from_numpy(a) for a in args), k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # Non-trivial: some rows select fewer than k, some exactly k.
    filled = (got[0] != -1).sum(dim=1)
    assert (filled < k).any() and (filled == k).any()


def test_wrapper_checks_and_cpu_dispatch():
    args = [torch.from_numpy(a) for a in random_rows(3)]
    before = recency_window_select.launches
    out = recency_window_select(*args, 3)
    assert recency_window_select.launches == before  # the plain version ran: no launch
    assert [o.dtype for o in out] == [torch.int32, torch.int32, torch.float32]
    assert out[2].shape == (70, 3, 6)
    with pytest.raises(ValueError):
        recency_window_select(*args, 9)  # k > B
    with pytest.raises(TypeError):
        recency_window_select(args[0], args[1], args[2].double(), *args[3:], 3)
    with pytest.raises(ValueError):
        recency_window_select(args[0], args[1], args[2][:, :, 0], *args[3:], 3)  # 2-D payload
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent fallback
        recency_window_select(*(a.to("meta") for a in args), 3)


def random_state(seed, B, D, num_nodes=30):
    """A feature-layout state in no time order (PAD slots, empty rows, wp
    past B, time ties), the dump row pristine, and 40 seeds whose first
    three are invalid (-1, N, N + 7), with query times."""
    rng = np.random.default_rng(seed)
    n = num_nodes + 1
    ids = rng.integers(-1, 9, (n, B)).astype(np.int32)
    ids[rng.random(n) < 0.1] = -1  # empty rows
    times = rng.integers(0, 30, (n, B)).astype(np.int32)
    feats = rng.normal(size=(n, B, D)).astype(np.float32)
    wp = rng.integers(0, 5 * B, n).astype(np.int32)
    ids[-1], times[-1], feats[-1], wp[-1] = -1, 0, 0.0, 0
    seeds = rng.integers(0, num_nodes, 40).astype(np.int32)
    seeds[:3] = [-1, num_nodes, num_nodes + 7]
    qt = rng.integers(0, 35, 40).astype(np.int32)
    return (ids, times, feats, wp), seeds, qt


@pytest.mark.parametrize("D", [0, 5, 172])
@pytest.mark.parametrize("k", [3, 8])  # K < B and K = B
def test_feats_select_plain_matches_pallas_on_jax_gathered_rows(k, D):
    B = 8
    state, seeds, qt = random_state(10 * k + D, B, D)
    j_ids, j_times, j_feats, j_wp = (jnp.asarray(a) for a in state)
    n = state[0].shape[0] - 1
    j_seeds = jnp.asarray(seeds)
    rows = jnp.where((j_seeds >= 0) & (j_seeds < n), j_seeds, n)
    # The Pallas kernel takes no zero-width payload: for D = 0 it carries a
    # one-column one, and only its ids and times are compared.
    payload = j_feats if D else jnp.zeros((n + 1, B, 1), jnp.float32)
    want = pallas_select(j_ids[rows], j_times[rows], payload[rows], j_wp[rows], jnp.asarray(qt),
                         k=k, block=16, interpret=True)
    got = recency_feats_select_plain(tuple(torch.from_numpy(a) for a in state),
                                     torch.from_numpy(seeds), torch.from_numpy(qt), k)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].shape == (40, k, D) and got[2].dtype == torch.float32
    if D:
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    # Invalid seeds read the empty dump row; some seeds select fewer than
    # k, some exactly k.
    assert (got[0][:3] == -1).all()
    filled = (got[0] != -1).sum(dim=1)
    assert (filled < k).any() and (filled == k).any()


def chronological_state(seed, B, D, num_nodes=25, batches=8, width=16):
    """A feature-layout state that JAX ``recency_update`` pushes built from a
    chronological stream (time ties, padded edges, some rows past B
    pushes), and 30 seeds (invalid ones among them) with query times."""
    rng = np.random.default_rng(seed)
    state = j_neighbors.recency_init(num_nodes, B, D)
    for b in range(batches):
        src = rng.integers(0, num_nodes - 3, width).astype(np.int32)
        dst = rng.integers(0, num_nodes - 3, width).astype(np.int32)
        t = np.sort(rng.integers(5 * b, 5 * b + 6, width)).astype(np.int32)
        valid = rng.random(width) < 0.9
        src[~valid], dst[~valid], t[~valid] = -1, -1, 0
        x = rng.normal(size=(width, D)).astype(np.float32)
        x[~valid] = 0.0
        state = j_neighbors.recency_update(
            state, *(jnp.asarray(a) for a in (src, dst, t, x, valid)), False)
    seeds = rng.integers(-1, num_nodes + 8, 30).astype(np.int32)
    seeds[:3] = [-1, num_nodes, num_nodes + 7]
    qt = rng.integers(0, 5 * batches + 8, 30).astype(np.int32)
    return state, seeds, qt


@pytest.mark.parametrize("D", [0, 5, 172])
@pytest.mark.parametrize("k", [4, 10])  # K < B and K = B
def test_feats_select_matches_jax_query_on_chronological_states(k, D):
    B = 10
    j_state, seeds, qt = chronological_state(k + D, B, D)
    want = j_neighbors.recency_query(j_state, jnp.asarray(seeds), jnp.asarray(qt), k)
    state = tuple(torch.from_numpy(np.array(a)) for a in j_state)
    assert (state[3][:-1] > B).any()  # some rows wrapped
    before = recency_feats_select.launches
    for got in (recency_feats_select_plain(state, torch.from_numpy(seeds), torch.from_numpy(qt), k),
                recency_feats_select(state, torch.from_numpy(seeds), torch.from_numpy(qt), k)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert got[2].shape == (30, k, D)
    assert recency_feats_select.launches == before  # the plain version ran: no launch
    filled = (got[0] != -1).sum(dim=1)
    assert (filled < k).any() and (filled == k).any()


def test_feats_select_wrapper_checks_and_cpu_dispatch():
    state, seeds, qt = random_state(5, 8, 6)
    state = tuple(torch.from_numpy(a) for a in state)
    seeds, qt = torch.from_numpy(seeds), torch.from_numpy(qt)
    before = recency_feats_select.launches
    out = recency_feats_select(state, seeds, qt, 3)
    assert recency_feats_select.launches == before  # the plain version ran: no launch
    assert [o.dtype for o in out] == [torch.int32, torch.int32, torch.float32]
    assert out[2].shape == (40, 3, 6)
    ids, times, feats, wp = state
    with pytest.raises(ValueError):
        recency_feats_select(state, seeds, qt, 9)  # k > B
    with pytest.raises(TypeError):
        recency_feats_select(state, seeds.long(), qt, 3)
    with pytest.raises(TypeError):
        recency_feats_select((ids, times, feats.double(), wp), seeds, qt, 3)
    with pytest.raises(ValueError):
        recency_feats_select((ids, times, feats[:, :, 0], wp), seeds, qt, 3)  # 2-D payload
    with pytest.raises(ValueError):
        recency_feats_select(state, seeds, qt[:-1], 3)
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent fallback
        recency_feats_select(tuple(a.to("meta") for a in state), seeds.to("meta"),
                             qt.to("meta"), 3)


def event_stream(seed):
    """Chronological edges with features in fixed-width batches; the last
    batch half padded (padded rows carry zero features, as the streams do)."""
    rng = np.random.default_rng(seed)
    E = BSIZE * N_BATCHES
    src = rng.integers(0, N - 3, E).astype(np.int32)  # nodes N-3.. stay empty
    dst = rng.integers(0, N - 3, E).astype(np.int32)
    t = np.sort(rng.integers(0, 40, E)).astype(np.int32)  # ties in and across batches
    valid = np.ones(E, bool)
    valid[-BSIZE // 2:] = False
    src[~valid], dst[~valid], t[~valid] = -1, -1, 0
    edge_x = rng.normal(size=(E, EDGE_DIM)).astype(np.float32)
    edge_x[~valid] = 0.0
    neg = rng.integers(-1, N + 2, (N_BATCHES, N_NEG)).astype(np.int32)  # PAD and invalid ids
    neg_t = rng.integers(0, 45, (N_BATCHES, N_NEG)).astype(np.int32)
    return src, dst, t, valid, edge_x, neg, neg_t


@pytest.mark.parametrize("directed", [False, True])
def test_feature_push_and_query_match_jax(directed):
    src, dst, t, valid, edge_x, neg, neg_t = event_stream(seed=7 + directed)
    j_state = j_neighbors.recency_init(N, K, EDGE_DIM)
    state = recency_init(N, K, EDGE_DIM, device="cpu")
    for b in range(N_BATCHES):
        sl = slice(b * BSIZE, (b + 1) * BSIZE)
        cols = (src[sl], dst[sl], t[sl], edge_x[sl], valid[sl])
        j_state = j_neighbors.recency_update(j_state, *(jnp.asarray(c) for c in cols), directed)
        state = recency_update(state, *(torch.from_numpy(c.copy()) for c in cols), directed)
        for got, want in zip(state, j_state):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"state @ {b}")
        got = recency_query(state, torch.from_numpy(neg[b]), torch.from_numpy(neg_t[b]), K)
        want = j_neighbors.recency_query(j_state, jnp.asarray(neg[b]), jnp.asarray(neg_t[b]), K)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"query @ {b}")
    # Some rows wrapped past B pushes; the dump row stayed pristine.
    assert (state[3][: N - 3].numpy() > K).any() and state[3][N] == 0
    assert (state[2][N] == 0).all() and (state[0][N] == -1).all()


@pytest.mark.parametrize("dense_push", [True, False])
def test_feature_layout_hook_matches_jax(monkeypatch, dense_push):
    monkeypatch.setattr(j_neighbors, "USE_DENSE_PUSH", dense_push)
    src, dst, t, valid, edge_x, neg, neg_t = event_stream(seed=3)
    keys = (["edge_src", "edge_dst", "neg"], ["edge_time", "edge_time", "neg_time"])
    j_hook = JRecency(N, [K], *keys, edge_dim=EDGE_DIM)
    hook = RecencyNeighborHook(N, [K], *keys, edge_dim=EDGE_DIM, device="cpu")
    j_apply = jax.jit(j_hook.apply)
    j_state, state = j_hook.init_state(None), hook.init_state(None)
    assert state[2].shape == (N + 1, K, EDGE_DIM)
    for b in range(N_BATCHES):
        sl = slice(b * BSIZE, (b + 1) * BSIZE)
        jb = JBatch(jnp.asarray(src[sl]), jnp.asarray(dst[sl]), jnp.asarray(t[sl]),
                    jnp.asarray(valid[sl]))
        jb.edge_x, jb.neg, jb.neg_time = (jnp.asarray(x) for x in (edge_x[sl], neg[b], neg_t[b]))
        pb = DGBatch(*(torch.from_numpy(x[sl].copy()) for x in (src, dst, t, valid)),
                     edge_x=torch.from_numpy(edge_x[sl].copy()),
                     neg=torch.from_numpy(neg[b].copy()), neg_time=torch.from_numpy(neg_t[b].copy()))
        j_state, jb = j_apply(j_state, jb)
        state, pb = hook.apply(state, pb)
        for name in ("seed_nids", "seed_times", "nbr_nids", "nbr_edge_time", "nbr_edge_x"):
            np.testing.assert_array_equal(getattr(pb, name)[0].numpy(),
                                          np.asarray(getattr(jb, name)[0]), err_msg=f"{name} @ {b}")
        for got, want in zip(state, j_state):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"state @ {b}")
    # The queries did carry features: the comparison is not of zeros.
    assert np.abs(pb.nbr_edge_x[0].numpy()).max() > 0.5


def test_feature_layout_width_from_graph_and_missing_edge_x():
    """Without ``edge_dim`` the buffer takes the graph's width; a batch
    without ``edge_x`` pushes zero features, as in the JAX package."""
    from tgm_tpu_torch import DGData, DGraph

    rng = np.random.default_rng(0)
    data = DGData.from_raw(np.arange(6), rng.integers(0, 4, (6, 2)),
                           rng.normal(size=(6, 3)).astype(np.float32))
    hook = RecencyNeighborHook(4, [2], ["edge_src"], ["edge_time"], device="cpu")
    state = hook.init_state(DGraph(data))
    assert state[2].shape == (5, 2, 3)
    batch = DGBatch(torch.tensor([0, 1], dtype=torch.int32), torch.tensor([2, 3], dtype=torch.int32),
                    torch.tensor([4, 5], dtype=torch.int32), torch.tensor([True, True]))
    state, batch = hook.apply(state, batch)
    assert (state[3][:4] == 1).all() and (state[2] == 0).all()
