"""The rest of the hook layer against the JAX package, on the CPU.

One random stream (30 nodes, 150 edges, 8 node features, batches of 32
with a padded tail) feeds the same batches, built with numpy from a seed,
to each JAX hook and its port, batch by batch:

* ``HistoricalNegativeEdgeSamplerHook`` with JAX's uniform weights injected
  (``draw_weights``): negatives, masks and the edge log exact, also when the
  log fills;
* the TGB hooks (tgbl / thgl / tkgl) on given candidates, mirroring
  ``tests/test_tgb_negatives_surface.py``: rows, unique candidates and the
  cursor exact;
* ``TimeGapNeighborMeanHook``, mirroring ``tests/test_timegap.py``: counts
  exact, means within 1e-6 * max |mean|;
* ``BatchAnalyticsHook`` and ``NodeAnalyticsHook`` in both bitmap modes,
  mirroring ``tests/test_batch_analytics.py`` and
  ``tests/test_node_analytics.py``: integer outputs and the state exact
  (the bitmap's words compared as uint32), float outputs within 1e-6;
* the seen-node track hook, the device hooks and the recipe;
* the exported names and ``list_hooks()``, equal to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tgm_tpu.hooks as jhooks
import tgm_tpu_torch.hooks as phooks
from tgm_tpu import DGData as JDGData
from tgm_tpu import DGraph as JDGraph
from tgm_tpu.core.batch import DGBatch as JBatch
from tgm_tpu_torch import DGData, DGraph
from tgm_tpu_torch.constants import RECIPE_TGB_LINK_PRED
from tgm_tpu_torch.core.batch import DGBatch
from tgm_tpu_torch.exceptions import UndefinedRecipeError

N, E, BSIZE, NODE_DIM, Q = 30, 150, 32, 8, 6
FLOAT_TOL = 1e-6  # relative to the largest magnitude of the JAX output


def make_stream(seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    src[-1] = N - 1  # the graph spans every node id
    t = np.sort(rng.integers(0, 60, E)).astype(np.int32)  # ties
    # A few repeated events: equal (src, dst, time) triplets.
    src[11], dst[11], t[11] = src[10], dst[10], t[10]
    node_x = rng.normal(size=(N, NODE_DIM)).astype(np.float32)
    return src, dst, t, node_x, rng


def batches(src, dst, t):
    """(src, dst, time, valid, edge_ids) numpy rows of width BSIZE, the
    tail padded with PAD / 0 / invalid / -1."""
    out = []
    for lo in range(0, E, BSIZE):
        n = min(BSIZE, E - lo)
        pad = lambda a, fill: np.concatenate([a[lo:lo + n], np.full(BSIZE - n, fill, a.dtype)])
        ids = np.concatenate([np.arange(lo, lo + n), np.full(BSIZE - n, -1)]).astype(np.int32)
        valid = np.arange(BSIZE) < n
        out.append((pad(src, -1), pad(dst, -1), pad(t, 0), valid, ids))
    return out


def both(rows, **extra):
    """The same rows as a JAX and a port batch."""
    s, d, t, v, ids = rows
    jb = JBatch(edge_src=jnp.asarray(s), edge_dst=jnp.asarray(d), edge_time=jnp.asarray(t),
                edge_valid=jnp.asarray(v))
    jb.edge_ids = jnp.asarray(ids)
    pb = DGBatch(torch.from_numpy(s), torch.from_numpy(d), torch.from_numpy(t),
                 torch.from_numpy(v), edge_ids=torch.from_numpy(ids))
    for k, a in extra.items():
        setattr(jb, k, jnp.asarray(a))
        setattr(pb, k, torch.from_numpy(np.asarray(a)))
    return jb, pb


def graphs(src, dst, t):
    edge_index = np.stack([src, dst], 1)
    return JDGraph(JDGData.from_raw(t, edge_index)), DGraph(DGData.from_raw(t, edge_index))


def assert_same(got, want, what):
    """Exact for integers and bools, within FLOAT_TOL * max |want| for floats."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}"
    if np.issubdtype(want.dtype, np.floating):
        tol = FLOAT_TOL * max(float(np.abs(want).max(initial=0.0)), 1.0)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)
    else:
        np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64), err_msg=what)


# ---------------------------------------------------------------------- #
# Negatives
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("epochs", [1, 2], ids=["one-pass", "log-full"])
def test_historical_sampler_matches_jax_with_injected_weights(epochs):
    src, dst, t, _, _ = make_stream(1)
    jdg, pdg = graphs(src, dst, t)
    jh = jhooks.HistoricalNegativeEdgeSamplerHook()
    ph = phooks.HistoricalNegativeEdgeSamplerHook(device="cpu")
    js, ps = jh.init_state(jdg), ph.init_state(pdg)
    C = ps[1].shape[0]
    assert C == E and int(ps[3]) == 0
    injected = []
    ph.draw_weights = lambda gen, size: injected.pop()
    apply = jax.jit(jh.apply)
    had_history = 0
    for e in range(epochs):  # a second pass runs with the log full
        for b, rows in enumerate(batches(src, dst, t)):
            _, sub = jax.random.split(js[0])
            injected.append(torch.from_numpy(np.array(jax.random.uniform(sub, (C,)))))
            jb, pb = both(rows)
            js, jb = apply(js, jb)
            ps, pb = ph.apply(ps, pb)
            for name in ("neg", "neg_time", "valid_neg_mask"):
                assert_same(getattr(pb, name), getattr(jb, name), f"{name} @ {e}.{b}")
            for i, name in ((1, "src_log"), (2, "dst_log"), (3, "count")):
                assert_same(ps[i], js[i], f"{name} @ {e}.{b}")
            had_history += int(pb.valid_neg_mask.sum())
    assert not injected and had_history > BSIZE
    assert int(ps[3]) == C


def test_historical_sampler_ties_take_the_largest_log_index():
    src, dst, t = (np.array(a, np.int32) for a in ([0, 0, 0, 1], [5, 6, 7, 8], [1, 2, 3, 4]))
    _, pdg = graphs(src, dst, t)
    h = phooks.HistoricalNegativeEdgeSamplerHook(device="cpu")
    state = h.init_state(pdg)
    rows = (src, dst, t, np.ones(4, bool), np.arange(4, dtype=np.int32))
    state, _ = h.apply(state, both(rows)[1])
    h.draw_weights = lambda gen, C: torch.full((C,), 0.5)  # every weight ties
    _, pb = h.apply(state, both(rows)[1])
    np.testing.assert_array_equal(pb.neg.numpy(), [7, 7, 7, 8])
    assert pb.valid_neg_mask.all()


@pytest.mark.parametrize("name", ["TGBNegativeEdgeSamplerHook", "TGBTHGNegativeEdgeSamplerHook",
                                  "TGBTKGNegativeEdgeSamplerHook"])
def test_tgb_hooks_match_jax_on_given_candidates(name):
    src, dst, t, _, rng = make_stream(2)
    cands = rng.integers(0, N, (E, Q))
    cands[rng.random((E, Q)) < 0.2] = -1  # ragged lists
    jh, ph = getattr(jhooks, name)(candidates=cands), getattr(phooks, name)(cands, device="cpu")
    assert isinstance(ph, phooks.TGBNegativeEdgeSamplerHook) == (
        name == "TGBNegativeEdgeSamplerHook")
    js, ps = jh.init_state(), ph.init_state()
    apply = jax.jit(jh.apply)
    ph.draw_neg_time = lambda n, lo, hi: torch.zeros(n, dtype=torch.int32)
    for b, rows in enumerate(batches(src, dst, t)):
        jb, pb = both(rows)
        js, jb = apply(js, jb)
        ps, pb = ph.apply(ps, pb)
        for attr in ("neg", "neg_batch_list", "neg_valid"):
            assert_same(getattr(pb, attr), getattr(jb, attr), f"{name} {attr} @ {b}")
        assert_same(ps, js[1], f"{name} cursor @ {b}")
    assert int(ps) == E


@pytest.mark.parametrize("cls", [phooks.TGBNegativeEdgeSamplerHook,
                                 phooks.TGBTHGNegativeEdgeSamplerHook,
                                 phooks.TGBTKGNegativeEdgeSamplerHook])
def test_tgb_hooks_surface(cls):
    with pytest.raises(ValueError, match="Provide either"):
        cls(device="cpu")
    with pytest.raises(ValueError, match="split_mode"):
        cls(dataset_name=f"{cls._dataset_prefix}-x", split_mode="train", device="cpu")
    with pytest.raises(ValueError, match="expects"):
        cls(dataset_name="nope-x", split_mode="val", device="cpu")
    with pytest.raises(ValueError, match="E_eval, Q"):
        cls(np.zeros(4), device="cpu")
    # Unique candidates, sorted, PAD at the end; ids suffix the products.
    h = cls(np.array([[3, 1, 3], [1, -1, 2]]), device="cpu", id="x")
    rows = (np.array([0, 1], np.int32), np.array([1, 2], np.int32), np.array([1, 2], np.int32),
            np.ones(2, bool), np.arange(2, dtype=np.int32))
    _, pb = h.apply(h.init_state(), both(rows)[1])
    np.testing.assert_array_equal(pb.neg_x.numpy(), [1, 2, 3, -1, -1, -1])
    assert h.produces == {"neg_x", "neg_batch_list_x", "neg_time_x", "neg_valid_x"}
    assert (pb.neg_time_x[:3] >= 1).all() and (pb.neg_time_x[:3] <= 2).all()


# ---------------------------------------------------------------------- #
# Time gap
# ---------------------------------------------------------------------- #
def test_time_gap_matches_jax_on_the_stream():
    src, dst, t, node_x, _ = make_stream(3)
    keys = ["edge_src", "edge_dst"]
    jh = jhooks.TimeGapNeighborMeanHook(src, dst, t, node_x, 40, keys)
    ph = phooks.TimeGapNeighborMeanHook(src, dst, t, node_x, 40, keys, device="cpu")
    apply = jax.jit(jh.apply)
    nonzero = 0
    for b, rows in enumerate(batches(src, dst, t)):
        jb, pb = both(rows)
        _, jb = apply(None, jb)
        _, pb = ph.apply(None, pb)
        assert_same(pb.time_gap_count, jb.time_gap_count, f"count @ {b}")
        assert_same(pb.time_gap_feat, jb.time_gap_feat, f"feat @ {b}")
        nonzero += int((pb.time_gap_count > 0).sum())
    assert nonzero > BSIZE


def test_time_gap_hand_computed_window():
    # The window mean of tests/test_timegap.py: only event 2 (1 -> 2 @ 3) is
    # in the window of a batch of events [3, 5).
    src, dst, t = (np.array(a, np.int32) for a in ([0, 0, 1, 0, 2], [1, 2, 2, 1, 3],
                                                  [1, 2, 3, 4, 5]))
    node_x = np.arange(5, dtype=np.float32)[:, None] * 10
    h = phooks.TimeGapNeighborMeanHook(src, dst, t, node_x, time_gap=3,
                                       seed_nodes_keys=["edge_src", "edge_dst"], device="cpu")
    rows = (np.array([0, 2], np.int32), np.array([1, 3], np.int32), np.array([4, 5], np.int32),
            np.ones(2, bool), np.array([3, 4], np.int32))
    _, pb = h.apply(None, both(rows)[1])
    np.testing.assert_array_equal(pb.time_gap_count.numpy(), [0, 1, 1, 0])
    np.testing.assert_allclose(pb.time_gap_feat[:, 0].numpy(), [0.0, 10.0, 20.0, 0.0])
    with pytest.raises(ValueError, match="time_gap"):
        phooks.TimeGapNeighborMeanHook(src, dst, t, node_x, 0, ["edge_src"], device="cpu")


# ---------------------------------------------------------------------- #
# Analytics
# ---------------------------------------------------------------------- #
def test_batch_analytics_matches_jax():
    src, dst, t, _, _ = make_stream(4)
    jh, ph = jhooks.BatchAnalyticsHook(), phooks.BatchAnalyticsHook()
    apply = jax.jit(jh.apply)
    repeated = 0
    for b, rows in enumerate(batches(src, dst, t)):
        jb, pb = both(rows)
        _, jb = apply(None, jb)
        _, pb = ph.apply(None, pb)
        for name in sorted(ph.produces):
            assert_same(getattr(pb, name), getattr(jb, name), f"{name} @ {b}")
        repeated += int(pb.num_repeated_edge_events)
    assert repeated >= 1


def test_batch_analytics_hand_computed():
    # tests/test_batch_analytics.py's batch: (0,1)@1 twice, (1,2)@2, (2,3)@2, (0,2)@5.
    rows = (np.array([0, 0, 1, 2, 0], np.int32), np.array([1, 1, 2, 3, 2], np.int32),
            np.array([1, 1, 2, 2, 5], np.int32), np.ones(5, bool), np.arange(5, dtype=np.int32))
    _, pb = phooks.BatchAnalyticsHook().apply(None, both(rows)[1])
    assert int(pb.num_edge_events) == 5 and int(pb.num_node_events) == 0
    assert int(pb.num_unique_timestamps) == 3 and int(pb.num_unique_nodes) == 4
    assert float(pb.avg_degree) == pytest.approx(2.5)
    assert int(pb.num_repeated_edge_events) == 1 and int(pb.num_repeated_node_events) == 0


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "hashed"])
def test_node_analytics_matches_jax(exact):
    src, dst, t, _, _ = make_stream(5)
    tracked = [0, 3, 3, 7, N - 1, 12]
    kw = dict(edge_hash_bits=6, exact_edges=exact)  # 64 hashed bits: collisions happen
    jh = jhooks.NodeAnalyticsHook(tracked, N, **kw)
    ph = phooks.NodeAnalyticsHook(tracked, N, device="cpu", **kw)
    js, ps = jh.init_state(), ph.init_state()
    apply = jax.jit(jh.apply)
    for b, rows in enumerate(batches(src, dst, t)):
        jb, pb = both(rows)
        js, jb = apply(js, jb)
        ps, pb = ph.apply(ps, pb)
        for group in ("node_stats", "node_macro_stats", "edge_stats"):
            for k, want in getattr(jb, group).items():
                assert_same(getattr(pb, group)[k], want, f"{group}.{k} @ {b}")
        for k in ("first_seen", "last_seen", "appearances"):
            assert_same(ps[k], js[k], f"state {k} @ {b}")
        # uint32 words against their int32 bit patterns
        assert_same(ps["seen_edges"], np.asarray(js["seen_edges"]).view(np.int32),
                    f"seen_edges @ {b}")
    assert bool(pb.edge_stats["novelty_is_exact"]) == exact
    assert 0.0 < float(pb.edge_stats["seen_bitmap_load"]) <= 1.0


def test_node_analytics_hash_wraps_like_int32():
    h = phooks.NodeAnalyticsHook([0], 1 << 20, device="cpu")
    assert not h._exact
    rng = np.random.default_rng(6)
    src = rng.integers(0, 1 << 20, 4096).astype(np.int32)
    dst = rng.integers(0, 1 << 20, 4096).astype(np.int32)
    jh = jhooks.NodeAnalyticsHook([0], 1 << 20)
    want = np.asarray(jh._edge_hash(jnp.asarray(src), jnp.asarray(dst)))
    got = h._edge_hash(torch.from_numpy(src), torch.from_numpy(dst)).numpy()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="positive"):
        phooks.NodeAnalyticsHook([0], 0, device="cpu")


# ---------------------------------------------------------------------- #
# Seen nodes, device hooks, the recipe, the surface
# ---------------------------------------------------------------------- #
def test_seen_node_track_matches_jax():
    src, dst, t, _, rng = make_stream(7)
    jh, ph = jhooks.EdgeEventsSeenNodesTrackHook(N), phooks.EdgeEventsSeenNodesTrackHook(
        N, device="cpu")
    js, ps = jh.init_state(), ph.init_state()
    apply = jax.jit(jh.apply)
    for b, rows in enumerate(batches(src, dst, t)):
        L = 8
        nids = rng.integers(0, N, L).astype(np.int32)
        nids[0] = rows[0][0]  # an endpoint of this batch: seen at once
        y_valid = np.arange(L) < 6
        jb, pb = both(rows, node_y_nids=np.where(y_valid, nids, -1), node_y_valid=y_valid)
        js, jb = apply(js, jb)
        ps, pb = ph.apply(ps, pb)
        for name in ("batch_nodes_mask", "seen_nodes"):
            assert_same(getattr(pb, name), getattr(jb, name), f"{name} @ {b}")
        assert_same(ps, js, f"state @ {b}")
        assert bool(pb.batch_nodes_mask[0])
    assert not bool(ps[N])


def test_device_hooks_and_recipe():
    rows = (np.array([0, 1], np.int32), np.array([1, 2], np.int32), np.array([1, 2], np.int32),
            np.ones(2, bool), np.arange(2, dtype=np.int32))
    _, pb = both(rows)
    pb.nbr_nids = [torch.zeros(2, 3)]
    for h in (phooks.PinMemoryHook(), phooks.DeviceTransferHook(), phooks.DeviceTransferHook(
            "cpu")):
        out = h(None, pb)
        assert out.edge_src.device.type == "cpu" and torch.equal(out.edge_src, pb.edge_src)
        assert isinstance(out.nbr_nids, list) and out.nbr_nids[0].shape == (2, 3)
    assert phooks.DeviceTransferHook().device is None

    src, dst, t, _, rng = make_stream(8)
    _, pdg = graphs(src, dst, t)
    cands = rng.integers(0, N, (10, Q))
    hm = phooks.RecipeRegistry.build(RECIPE_TGB_LINK_PRED, dataset_name="tgbl-x", train_dg=pdg,
                                     val_candidates=cands, test_candidates=cands, device="cpu")
    assert phooks.build_tgb_link_pred is phooks.RecipeRegistry._recipes[RECIPE_TGB_LINK_PRED]
    assert hm.keys == ["train", "val", "test"]
    neg = hm._key_to_hooks["train"][0]
    assert (neg.low, neg.high) == (int(pdg.edge_dst.min()), int(pdg.edge_dst.max()))
    assert isinstance(hm._key_to_hooks["val"][0], phooks.TGBNegativeEdgeSamplerHook)
    with pytest.raises(UndefinedRecipeError, match="Available"):
        phooks.RecipeRegistry.build("nope")


def test_the_port_exports_every_jax_hook_name():
    assert set(jhooks.__all__) <= set(phooks.__all__)
    assert [c.__name__ for c in phooks.list_hooks()] == [c.__name__ for c in jhooks.list_hooks()]
    assert phooks.CORE_ATTRIBUTE == jhooks.CORE_ATTRIBUTE
