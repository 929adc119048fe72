"""The recency push's plain version against the JAX package's push.

``recency_push_plain`` (and the ``recency_push`` wrapper, which runs it on
CPU tensors) against ``tgm_tpu.hooks.neighbors`` ``recency_update`` (feature
layout) and ``recency_eid_update`` (eid layout), with the JAX push's dense
plan and its sorted one, directed and undirected, over several pushes into
one state. The batches hold invalid edges (some with real node ids), time
ties and times out of order, more than B events of one node in one push,
and events at node N - 1, next to the dump row. All four state tensors are
compared after every push. Tolerance: exact equality (integers, and fp32
features copied by value).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgm_tpu.hooks import neighbors as j_neighbors
from tgm_tpu_torch.hooks.neighbors import recency_eid_init, recency_init
from tgm_tpu_torch.ops import push_plan_dense, recency_push, recency_push_plain

N, B, D, E, PUSHES = 12, 4, 5, 16, 5


def batches(seed):
    rng = np.random.default_rng(seed)
    out = []
    for p in range(PUSHES):
        src = rng.integers(0, N, E).astype(np.int32)
        dst = rng.integers(0, N, E).astype(np.int32)
        src[: B + 2] = 0  # node 0: more than B events in this push
        src[B + 2], dst[B + 3: B + 5] = N - 1, N - 1  # the last live node, by the dump row
        t = (10 * p + rng.integers(0, 4, E)).astype(np.int32)  # ties, not sorted
        valid = rng.random(E) > 0.2
        valid[-2:] = False
        src[-1], dst[-1], t[-1] = -1, -1, 0  # a padded row, as the streams pad
        eids = (100 * p + np.arange(E)).astype(np.int32)
        feats = rng.normal(size=(E, D)).astype(np.float32)
        out.append((src, dst, t, valid, eids, feats))
    return out


@pytest.mark.parametrize("dense_push", [True, False])
@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("layout", ["eid", "feature"])
def test_push_plain_matches_jax(monkeypatch, layout, directed, dense_push):
    monkeypatch.setattr(j_neighbors, "USE_DENSE_PUSH", dense_push)
    if layout == "eid":
        j_state, state = j_neighbors.recency_eid_init(N, B), recency_eid_init(N, B, "cpu")
    else:
        j_state, state = j_neighbors.recency_init(N, B, D), recency_init(N, B, D, "cpu")
    for p, (src, dst, t, valid, eids, feats) in enumerate(batches(seed=layout == "eid")):
        payload = eids if layout == "eid" else feats
        update = j_neighbors.recency_eid_update if layout == "eid" else j_neighbors.recency_update
        j_state = update(j_state, *(jnp.asarray(x) for x in (src, dst, t, payload, valid)),
                         directed)
        cols = [torch.from_numpy(x.copy()) for x in (src, dst, t, payload, valid)]
        if p % 2:  # the wrapper runs the plain version on CPU tensors
            before = recency_push.launches
            state = recency_push(*state, *cols, directed)
            assert recency_push.launches == before
        else:
            state = recency_push_plain(*state, *cols, directed)
        for name, got, want in zip(("nbr_ids", "nbr_times", "payload", "write_pos"), state,
                                   j_state):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"{name} after push {p}")
    wp = state[3].numpy()
    assert wp[0] > 2 * B and wp[N - 1] > 0 and wp[N] == 0
    assert (state[0][N] == -1).all() and (state[2][N] == (-1 if layout == "eid" else 0)).all()


def test_push_plan_drops_the_oldest_events_of_a_node():
    """Six events of node 0 in one push into B = 4 slots: the two oldest
    (by time, then position) are dropped, the rest fill columns wp..wp+3."""
    src = torch.tensor([0, 0, 0, 0, 0, 0, 1], dtype=torch.int32)
    dst = torch.tensor([1, 2, 3, 4, 5, 6, 7], dtype=torch.int32)
    t = torch.tensor([5, 3, 5, 1, 9, 3, 0], dtype=torch.int32)
    write_pos = torch.tensor([2, 0, 0, 0], dtype=torch.int32)
    rows, cols, _, _, rows_last, wp_last = push_plan_dense(4, write_pos, src, dst, t, None, True, 3)
    # Order by (time, position): events 3, 1, 5, 0, 2, 4; events 3 and 1 drop.
    assert rows.tolist() == [0, 3, 0, 3, 0, 0, 1]
    assert [c for r, c in zip(rows.tolist(), cols.tolist()) if r == 0] == [3, 0, 1, 2]
    assert cols[5] == 2 and rows_last.tolist() == [3, 3, 3, 3, 0, 3, 1]
    assert wp_last[4] == 6 and wp_last[6] == 1


def test_push_wrapper_checks():
    state = recency_eid_init(N, B, "cpu")
    src, dst, t, valid, eids, feats = batches(seed=0)[0]
    cols = [torch.from_numpy(x.copy()) for x in (src, dst, t, eids, valid)]
    with pytest.raises(TypeError):  # a feature payload into the eid layout
        recency_push(*state, *cols[:3], torch.from_numpy(feats[:, 0].copy()), cols[4], False)
    with pytest.raises(TypeError):
        recency_push(*state, cols[0].long(), *cols[1:], False)
    with pytest.raises(ValueError):
        recency_push(*state, cols[0][:-1], *cols[1:], False)
    with pytest.raises(TypeError):  # valid must be bool
        recency_push(*state, *cols[:4], cols[4].int(), False)
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent fallback
        recency_push(*(x.to("meta") for x in state), *(c.to("meta") for c in cols), False)
    fstate = recency_init(N, B, D, "cpu")
    with pytest.raises(ValueError):  # feature rows of another width
        recency_push(*fstate, *cols[:3], torch.from_numpy(feats[:, :3].copy()), cols[4], False)
