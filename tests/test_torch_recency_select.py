"""K1's plain version against the JAX recency select (jnp path and Pallas interpret).

Ring buffers come from pushing chronological event streams (with time ties)
through the JAX package; seeds include invalid ids, and nodes never pushed
leave empty rows with wp = 0 and PAD slots. On rows whose times are not
chronological the plain version follows the Pallas kernels' rank rule, as
K1 does, where the JAX jnp path takes the window ending at the last valid
slot. Tolerance: exact equality.

The fused entry ``recency_eid_select`` (rows read from the state in place,
edge features copied) is held to the JAX ``recency_eid_query`` on its
Pallas path (interpret mode, both kernel variants) followed by the JAX
``gather_edge_feats``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgm_tpu.hooks import neighbors as j_neighbors
from tgm_tpu.hooks.neighbors import gather_edge_feats as j_gather_edge_feats
from tgm_tpu.hooks.neighbors import recency_eid_init as j_init
from tgm_tpu.hooks.neighbors import recency_eid_query as j_query
from tgm_tpu.hooks.neighbors import recency_eid_update as j_update
from tgm_tpu.ops.pallas import recency_select as j_pallas
from tgm_tpu.ops.pallas.recency_select import (
    recency_window_select_eid,
    recency_window_select_eid_lanes,
)
from tgm_tpu_torch.hooks.neighbors import recency_eid_query
from tgm_tpu_torch.ops import recency_eid_select, recency_eid_select_plain
from tgm_tpu_torch.ops import recency_window_select_eid as port_select
from tgm_tpu_torch.ops import recency_window_select_eid_plain

NUM_NODES, BUF = 30, 6


def jax_state(seed, events=90, chunk=15):
    rng = np.random.default_rng(seed)
    state = j_init(NUM_NODES, BUF)
    # Nodes >= 25 are never pushed: their rows stay empty (wp = 0).
    src = jnp.asarray(rng.integers(0, 25, events), jnp.int32)
    dst = jnp.asarray(rng.integers(0, 25, events), jnp.int32)
    t = jnp.asarray(np.sort(rng.integers(0, 200, events)), jnp.int32)  # many ties
    eids = jnp.arange(events, dtype=jnp.int32)
    for i in range(0, events, chunk):
        sl = slice(i, i + chunk)
        state = j_update(state, src[sl], dst[sl], t[sl], eids[sl], None, directed=False)
    seeds = rng.integers(-2, NUM_NODES + 3, 40).astype(np.int32)  # invalid ids included
    qt = rng.integers(0, 260, 40).astype(np.int32)
    return state, seeds, qt


def to_torch(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("k", [1, 3, BUF])
def test_plain_matches_jax_query_and_pallas(k):
    state, seeds, qt = jax_state(seed=k)
    want = [np.asarray(w) for w in j_query(state, jnp.asarray(seeds), jnp.asarray(qt), k)]
    # The scenario covers every case: ties, PAD slots, empty rows, invalid seeds.
    wp = np.asarray(state[3])
    assert (wp[:NUM_NODES] == 0).any() and (wp[:NUM_NODES] > BUF).any()
    assert ((seeds < 0) | (seeds >= NUM_NODES)).any()

    port_state = tuple(to_torch(x) for x in state)
    got = recency_eid_query(port_state, torch.from_numpy(seeds), torch.from_numpy(qt), k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)

    rows = np.where((seeds >= 0) & (seeds < NUM_NODES), seeds, NUM_NODES)
    gathered = [np.asarray(x)[rows] for x in state]
    plain = recency_window_select_eid_plain(*(torch.from_numpy(g) for g in gathered),
                                            torch.from_numpy(qt), k)
    jg = [jnp.asarray(g) for g in gathered] + [jnp.asarray(qt)]
    for pallas in (recency_window_select_eid, recency_window_select_eid_lanes):
        kern = pallas(*jg, k=k, block=16, interpret=True)
        for p, w in zip(plain, kern):
            np.testing.assert_array_equal(p.numpy(), np.asarray(w))


def test_wrapper_checks_and_cpu_dispatch():
    state, seeds, qt = jax_state(seed=0)
    rows = np.where((seeds >= 0) & (seeds < NUM_NODES), seeds, NUM_NODES)
    args = [torch.from_numpy(np.asarray(x)[rows]) for x in state] + [torch.from_numpy(qt)]
    before = port_select.launches
    out = port_select(*args, 3)
    assert port_select.launches == before  # the plain version ran: no launch
    assert [o.dtype for o in out] == [torch.int32] * 3
    with pytest.raises(ValueError):
        port_select(*args, BUF + 1)  # k > B
    with pytest.raises(TypeError):
        port_select(args[0].long(), *args[1:], 3)
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent fallback
        port_select(*(a.to("meta") for a in args), 3)


def test_plain_follows_the_pallas_rank_rule_on_non_chronological_rows():
    """Slots (t = 5, 9, 3, 4) oldest to newest, query time 6, K = 3: the
    Pallas kernels and the plain version skip the slot at t = 9; the jnp
    path's window ending at the last valid slot keeps it."""
    row = [np.array([[7, 8, 9, 10]], np.int32), np.array([[5, 9, 3, 4]], np.int32),
           np.array([[70, 80, 90, 100]], np.int32), np.array([4], np.int32),
           np.array([6], np.int32)]
    plain = recency_window_select_eid_plain(*(torch.from_numpy(a) for a in row), 3)
    kern = recency_window_select_eid(*(jnp.asarray(a) for a in row), k=3, block=8, interpret=True)
    assert plain[0].tolist() == [[7, 9, 10]] == np.asarray(kern[0]).tolist()
    ids, times, eids, wp, qt = row
    state = (jnp.asarray(np.vstack([ids, np.full_like(ids, -1)])),  # node 0, then the dump row
             jnp.asarray(np.vstack([times, np.zeros_like(times)])),
             jnp.asarray(np.vstack([eids, np.full_like(eids, -1)])),
             jnp.asarray(np.append(wp, 0)))
    jnp_path = j_query(state, jnp.asarray([0]), jnp.asarray(qt), 3)
    assert np.asarray(jnp_path[0]).tolist() == [[8, 9, 10]]


@pytest.mark.parametrize("k", [1, 4, 8])
def test_plain_matches_pallas_on_random_rows(k):
    """Random rows in no time order, PAD slots, wp past B: exact against both
    Pallas variants."""
    rng = np.random.default_rng(k)
    S, B = 90, 8
    ids = rng.integers(-1, 6, (S, B)).astype(np.int32)
    times = rng.integers(0, 20, (S, B)).astype(np.int32)
    eids = rng.integers(0, 500, (S, B)).astype(np.int32)
    wp = rng.integers(0, 4 * B, S).astype(np.int32)
    qt = rng.integers(0, 24, S).astype(np.int32)
    args = (ids, times, eids, wp, qt)
    plain = recency_window_select_eid_plain(*(torch.from_numpy(a) for a in args), k)
    for pallas in (recency_window_select_eid, recency_window_select_eid_lanes):
        kern = pallas(*(jnp.asarray(a) for a in args), k=k, block=16, interpret=True)
        for p, w in zip(plain, kern):
            np.testing.assert_array_equal(p.numpy(), np.asarray(w))


@pytest.mark.parametrize("lanes", [False, True])
@pytest.mark.parametrize("k", [1, 3, BUF])
def test_fused_select_plain_matches_jax_pallas_query_and_gather(monkeypatch, k, lanes):
    """The JAX query on its Pallas path (row-major or lane-major kernel, in
    interpret mode) plus ``gather_edge_feats`` against the fused entry's
    plain version and its wrapper on CPU tensors, with and without the edge
    table. Seeds include -2, -1 and ids >= N; nodes >= 25 have empty rows."""
    monkeypatch.setattr(j_neighbors, "USE_PALLAS_RECENCY", True)
    monkeypatch.setattr(j_neighbors, "LANE_SELECT_MIN_SEEDS", 0 if lanes else 10**9)
    for name in ("recency_window_select_eid", "recency_window_select_eid_lanes"):
        monkeypatch.setattr(j_pallas, name, functools.partial(getattr(j_pallas, name), block=16,
                                                              interpret=True))
    state, seeds, qt = jax_state(seed=20 + k)
    edge_x = np.random.default_rng(k).normal(size=(90, 7)).astype(np.float32)
    j_ids, j_times, j_eids = j_query(state, jnp.asarray(seeds), jnp.asarray(qt), k)
    want = [np.asarray(x) for x in (j_ids, j_times, j_eids,
                                    j_gather_edge_feats(jnp.asarray(edge_x), j_eids))]
    assert (want[2] == -1).any() and (want[2] >= 0).any() and np.abs(want[3]).max() > 0.5

    port_state = tuple(to_torch(x) for x in state)
    args = (port_state, torch.from_numpy(seeds), torch.from_numpy(qt), k)
    before = recency_eid_select.launches
    for got in (recency_eid_select_plain(*args, torch.from_numpy(edge_x)),
                recency_eid_select(*args, torch.from_numpy(edge_x))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
    assert recency_eid_select.launches == before  # the plain version ran: no launch
    bare = recency_eid_select(*args)
    assert bare[3].shape == (len(seeds), k, 0)
    for g, w in zip(bare[:3], want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_fused_select_wrapper_checks():
    state, seeds, qt = jax_state(seed=0)
    port_state = tuple(to_torch(x) for x in state)
    s, t = torch.from_numpy(seeds), torch.from_numpy(qt)
    edge_x = torch.zeros((5, 3))
    with pytest.raises(TypeError):
        recency_eid_select(port_state, s.long(), t, 2, edge_x)
    with pytest.raises(ValueError):
        recency_eid_select(port_state, s, t[:-1], 2, edge_x)
    with pytest.raises(ValueError):
        recency_eid_select(port_state, s, t, BUF + 1, edge_x)  # k > B
    with pytest.raises(ValueError):
        recency_eid_select(port_state, s, t, 2, edge_x.double())
    with pytest.raises(ValueError):
        recency_eid_select(port_state, s, t, 2, edge_x[:0])  # no rows to read
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent fallback
        recency_eid_select(tuple(x.to("meta") for x in port_state), s.to("meta"), t.to("meta"), 2)
