"""The port's two-hop ``RecencyNeighborHook`` against the JAX hook, batch by batch.

A chronological stream of 6 batches of 16 edges (time ties inside and
across batches, the last batch half padded, three nodes left without
events) with 12 candidate seeds a batch that include PAD and out-of-range
ids, through both state layouts (eid: features gathered from the static
table; feature: features carried by value in the rings), undirected and
directed, with ``num_nbrs`` [4, 2] and [2, 4] (the rings hold 4 slots
either way). Hop 1's seeds are hop 0's neighbours, PAD included, so PAD
seeds read the dump row.

Tolerance: exact equality of every per-hop product (seed ids and times,
neighbour ids, times and features), of the seed mask and of the state
after every batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgm_tpu.core.batch import DGBatch as JBatch
from tgm_tpu.hooks import RecencyNeighborHook as JRecency
from tgm_tpu_torch.core.batch import DGBatch
from tgm_tpu_torch.hooks import RecencyNeighborHook

N, BSIZE, N_BATCHES, EDGE_DIM, N_NEG = 25, 16, 6, 3, 12
PRODUCTS = ("seed_nids", "seed_times", "nbr_nids", "nbr_edge_time", "nbr_edge_x")


def event_stream(seed):
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


@pytest.mark.parametrize("num_nbrs", [[4, 2], [2, 4]])
@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("layout", ["eid", "feature"])
def test_two_hop_hook_stream_matches_jax(layout, directed, num_nbrs):
    src, dst, t, valid, eids, edge_x, neg, neg_t = event_stream(seed=11 + directed)
    keys = (["edge_src", "edge_dst", "neg"], ["edge_time", "edge_time", "neg_time"])
    table = dict(edge_x_full=edge_x) if layout == "eid" else {}
    j_hook = JRecency(N, num_nbrs, *keys, directed=directed, edge_dim=EDGE_DIM, **table)
    hook = RecencyNeighborHook(N, num_nbrs, *keys, directed=directed, edge_dim=EDGE_DIM,
                               device="cpu", **table)
    j_apply = jax.jit(j_hook.apply)
    j_state, state = j_hook.init_state(None), hook.init_state(None)
    assert state[0].shape == (N + 1, max(num_nbrs))
    live_hop2 = 0
    for b in range(N_BATCHES):
        sl = slice(b * BSIZE, (b + 1) * BSIZE)
        jb = JBatch(jnp.asarray(src[sl]), jnp.asarray(dst[sl]), jnp.asarray(t[sl]),
                    jnp.asarray(valid[sl]))
        jb.edge_ids, jb.neg, jb.neg_time = (jnp.asarray(x) for x in (eids[sl], neg[b], neg_t[b]))
        jb.edge_x = jnp.asarray(edge_x[sl])
        up = lambda x: torch.from_numpy(np.array(x))
        pb = DGBatch(*(up(x[sl]) for x in (src, dst, t, valid)), edge_ids=up(eids[sl]),
                     edge_x=up(edge_x[sl]), neg=up(neg[b]), neg_time=up(neg_t[b]))
        j_state, jb = j_apply(j_state, jb)
        state, pb = hook.apply(state, pb)
        for name in PRODUCTS:
            got, want = getattr(pb, name), getattr(jb, name)
            assert len(got) == len(want) == 2, name
            for hop in range(2):
                np.testing.assert_array_equal(got[hop].numpy(), np.asarray(want[hop]),
                                              err_msg=f"{name}[{hop}] @ batch {b}")
        # Hop 1's seeds are hop 0's neighbours, flattened.
        np.testing.assert_array_equal(pb.seed_nids[1].numpy(), pb.nbr_nids[0].reshape(-1).numpy())
        assert pb.nbr_nids[1].shape == (pb.seed_nids[1].shape[0], num_nbrs[1])
        for key, rows in pb.seed_node_nbr_mask.items():
            np.testing.assert_array_equal(rows.numpy(), np.asarray(jb.seed_node_nbr_mask[key]))
        for i, (got, want) in enumerate(zip(state, j_state)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"state {i} @ batch {b}")
        live_hop2 += int((pb.nbr_nids[1] != -1).sum())
    # The stream reached the second hop: hop-1 seeds found neighbours of their own.
    assert live_hop2 > 0
    assert (state[3].numpy()[: N - 3] > max(num_nbrs)).any()
