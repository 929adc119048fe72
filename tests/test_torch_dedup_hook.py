"""The port's ``DeduplicationHook`` against the JAX hook, exactly.

* Direct ``apply`` on hand-made batches (made with numpy from a seed): edge
  endpoints with PAD rows, seed keys holding PAD, negative and out-of-range
  ids, and ``nbr_nids`` of one or two hops; the capacity cap at
  ``num_nodes + 1`` (more ids than nodes) and the uncapped case (fewer).
* ``register_shared`` after a two-hop recency hook, as the TGN example
  registers it, over a train stream (random negatives, the JAX draws
  injected) and a val stream (TGB candidates, the JAX ``neg_time`` draws
  injected), batch by batch.
* A missing seed attribute raises ``ValueError``.

Tolerance: exact equality of ``unique_nids``, ``num_unique`` and
``global_to_local`` (int32, shapes included).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgm_tpu import DGData as JDGData
from tgm_tpu import DGraph as JDGraph
from tgm_tpu.core.batch import DGBatch as JBatch
from tgm_tpu.hooks import DeduplicationHook as JDedup
from tgm_tpu.hooks import HookManager as JHookManager
from tgm_tpu.hooks import RandomNegativeEdgeSamplerHook as JRandomNeg
from tgm_tpu.hooks import RecencyNeighborHook as JRecency
from tgm_tpu.hooks import TGBNegativeEdgeSamplerHook as JTGB
from tgm_tpu.train import DeviceEdgeStream as JStream
from tgm_tpu_torch import DGData, DGraph
from tgm_tpu_torch.core.batch import DGBatch
from tgm_tpu_torch.hooks import (
    DeduplicationHook,
    HookManager,
    RandomNegativeEdgeSamplerHook,
    RecencyNeighborHook,
    TGBNegativeEdgeSamplerHook,
    list_hooks,
)
from tgm_tpu_torch.train import DeviceEdgeStream

PRODUCTS = ("unique_nids", "num_unique", "global_to_local")


def assert_products_equal(pb, jb, where=""):
    for name in PRODUCTS:
        got, want = getattr(pb, name), np.asarray(getattr(jb, name))
        assert got.dtype == torch.int32, name
        assert tuple(got.shape) == want.shape, (name, got.shape, want.shape)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{name} {where}")


def direct_batch(rng, n, B, hops, n_neg):
    valid = np.arange(B) < B - 3
    src = np.where(valid, rng.integers(0, n, B), -1).astype(np.int32)
    dst = np.where(valid, rng.integers(0, n, B), -1).astype(np.int32)
    neg = rng.integers(-3, n + 4, n_neg).astype(np.int32)  # PAD, negative, out of range
    S = 2 * B + n_neg
    nbrs = []
    for K in hops:
        nbrs.append(rng.integers(-1, n + 2, (S, K)).astype(np.int32))
        S *= K
    t = np.zeros(B, np.int32)
    jb = JBatch(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(t), jnp.asarray(valid))
    jb.neg = jnp.asarray(neg)
    jb.nbr_nids = [jnp.asarray(x) for x in nbrs]
    up = lambda x: torch.from_numpy(np.array(x))
    pb = DGBatch(up(src), up(dst), up(t), up(valid), neg=up(neg), nbr_nids=[up(x) for x in nbrs])
    return jb, pb


@pytest.mark.parametrize("n, hops", [
    (30, [4]),  # 3,000 ids over 31 slots: capped at num_nodes + 1
    (30, [3, 2]),
    (5_000, [4]),  # fewer ids than nodes: U = the id count
    (5_000, [2, 3]),
])
def test_direct_apply_matches_jax(n, hops):
    rng = np.random.default_rng(n + len(hops))
    jb, pb = direct_batch(rng, n, B=40, hops=hops, n_neg=25)
    keys = ["neg", "nbr_nids"]
    _, jb = JDedup(n, seed_nodes_keys=keys).apply(None, jb)
    _, pb = DeduplicationHook(n, seed_nodes_keys=keys).apply(None, pb)
    assert_products_equal(pb, jb)
    total = 2 * 40 + 25 + sum(x.numel() for x in pb.nbr_nids)
    assert pb.unique_nids.shape[0] == min(total, n + 1)
    u = pb.unique_nids.numpy()
    k = int(pb.num_unique)
    assert (np.diff(u[:k]) > 0).all() and (u[k:] == -1).all()
    assert int(pb.global_to_local[n]) == -1


def test_call_and_seed_keys_without_neighbours_match_jax():
    rng = np.random.default_rng(3)
    jb, pb = direct_batch(rng, 50, B=20, hops=[2], n_neg=7)
    jb = JDedup(50, seed_nodes_keys=["neg"])(None, jb)
    pb = DeduplicationHook(50, seed_nodes_keys=["neg"])(None, pb)
    assert_products_equal(pb, jb)
    assert pb.unique_nids.shape[0] == 2 * 20 + 7


def test_missing_seed_attribute_raises():
    rng = np.random.default_rng(4)
    _, pb = direct_batch(rng, 20, B=10, hops=[2], n_neg=3)
    with pytest.raises(ValueError, match="Missing seed node attribute neg_time"):
        DeduplicationHook(20, seed_nodes_keys=["neg_time"]).apply(None, pb)
    assert DeduplicationHook in list_hooks()
    hook = DeduplicationHook(20, seed_nodes_keys=["neg", "nbr_nids"])
    assert hook.requires == {"edge_src", "edge_dst", "neg", "nbr_nids"}
    assert hook.produces == {"unique_nids", "num_unique", "global_to_local"}
    assert not hook.has_state


N, E, BSIZE, Q, EDGE_DIM, HOPS = 60, 480, 40, 4, 3, [3, 2]
SPLITS = ("train", "val")


def make_stream(seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N - 2, E)
    dst = rng.integers(0, N - 2, E)
    dst = np.where(dst == src, (dst + 1) % (N - 2), dst)
    t = np.sort(rng.integers(0, 3 * E, E))
    edge_x = rng.normal(size=(E, EDGE_DIM)).astype(np.float32)
    return src, dst, t, edge_x, rng


def test_register_shared_after_the_recency_hook_matches_jax():
    src, dst, t, edge_x, rng = make_stream()
    keys = (["edge_src", "edge_dst", "neg"], ["edge_time", "edge_time", "neg_time"])
    jdata = JDGData.from_raw(t, np.stack([src, dst], 1), edge_x)
    data = DGData.from_raw(t, np.stack([src, dst], 1), edge_x)
    jdgs = dict(zip(SPLITS, (JDGraph(d) for d in jdata.split()[:2])))
    dgs = dict(zip(SPLITS, (DGraph(d) for d in data.split()[:2])))
    cands = rng.integers(0, N, (dgs["val"].num_edge_events, Q))

    jhm = JHookManager(keys=list(SPLITS))
    jhm.register("train", JRandomNeg(low=0, high=N))
    jhm.register("val", JTGB(candidates=cands))
    jhm.register_shared(JRecency(N, HOPS, *keys, edge_dim=EDGE_DIM, edge_x_full=jdata.edge_x))
    jhm.register_shared(JDedup(N, seed_nodes_keys=["neg", "nbr_nids"]))

    injected = {"neg": [], "neg_time": []}
    hm = HookManager(keys=list(SPLITS))
    rnd = RandomNegativeEdgeSamplerHook(low=0, high=N, device="cpu")
    rnd.draw_neg = lambda size: torch.from_numpy(injected["neg"].pop(0))
    tgb = TGBNegativeEdgeSamplerHook(cands, device="cpu")
    tgb.draw_neg_time = lambda n, lo, hi: torch.from_numpy(injected["neg_time"].pop(0))
    hm.register("train", rnd)
    hm.register("val", tgb)
    hm.register_shared(RecencyNeighborHook(N, HOPS, *keys, edge_dim=EDGE_DIM,
                                           edge_x_full=data.edge_x, device="cpu"))
    hm.register_shared(DeduplicationHook(N, seed_nodes_keys=["neg", "nbr_nids"]))

    checked = 0
    for split in SPLITS:
        jfn, jstates = jhm.as_transform(split, jdgs[split])
        jfn = jax.jit(jfn)
        fn, states = hm.as_transform(split, dgs[split])
        jstream = JStream(jdgs[split], BSIZE)
        stream = DeviceEdgeStream(dgs[split], BSIZE, device="cpu")
        for i in range(stream.num_batches):
            jstates, jb = jfn(jstates, jstream.batch_at(i))
            name = "neg" if split == "train" else "neg_time"
            injected[name].append(np.array(getattr(jb, name)))
            states, pb = fn(states, stream.batch_at(i))
            assert_products_equal(pb, jb, f"{split} batch {i}")
            checked += 1
        jhm.adopt_states(split, jstates)
        hm.adopt_states(split, states)
    assert checked == 9 + 2  # 336 train edges, 72 val edges
    assert not injected["neg"] and not injected["neg_time"]
