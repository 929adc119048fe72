"""K1's plain version against the JAX recency select (jnp path and Pallas interpret).

Ring buffers come from pushing chronological event streams (with time ties)
through the JAX package; seeds include invalid ids, and nodes never pushed
leave empty rows with wp = 0 and PAD slots. On rows whose times are not
chronological the plain version follows the Pallas kernels' rank rule, as
K1 does, where the JAX jnp path takes the window ending at the last valid
slot. Tolerance: exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgm_tpu.hooks.neighbors import recency_eid_init as j_init
from tgm_tpu.hooks.neighbors import recency_eid_query as j_query
from tgm_tpu.hooks.neighbors import recency_eid_update as j_update
from tgm_tpu.ops.pallas.recency_select import (
    recency_window_select_eid,
    recency_window_select_eid_lanes,
)
from tgm_tpu_torch.hooks.neighbors import recency_eid_query
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
