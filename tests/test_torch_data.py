"""The port's data layer, stream and hook manager against the JAX package's.

``DGData.from_raw`` and its splits, ``DGraph``'s accessors and
``DeviceEdgeStream``'s batch windows on the CPU; exact equality. The hook
manager's ordering and protocol checks are held to the JAX manager's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgm_tpu import DGData as JDGData
from tgm_tpu import DGraph as JDGraph
from tgm_tpu.core._storage.base import DGSliceTracker as JDGSliceTracker
from tgm_tpu.data.split import TGBSplit as JTGBSplit
from tgm_tpu.hooks import HookManager as JHookManager
from tgm_tpu.hooks import RecencyNeighborHook as JRecency
from tgm_tpu.hooks import TGBNegativeEdgeSamplerHook as JTGB
from tgm_tpu.train import DeviceEdgeStream as JStream
from tgm_tpu_torch import DGBatch, DGData, DGraph
from tgm_tpu_torch.core._storage import DGSliceTracker
from tgm_tpu_torch.data import TemporalSplit, TGBSplit
from tgm_tpu_torch.exceptions import (
    BadHookProtocolError,
    EmptyGraphError,
    InvalidNodeIDError,
    UnresolvableHookDependenciesError,
)
from tgm_tpu_torch.hooks import HookManager, RecencyNeighborHook, StatelessHook, TGBNegativeEdgeSamplerHook
from tgm_tpu_torch.train import DeviceEdgeStream


def raw_events(seed=0, E=300, N=40, D=5):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 1000, E)  # unsorted: from_raw sorts it, stably
    ei = rng.integers(0, N, (E, 2))
    x = rng.normal(size=(E, D)).astype(np.float32)
    return t, ei, x


def test_from_raw_and_splits_match_jax():
    t, ei, x = raw_events()
    data, j_data = DGData.from_raw(t, ei, x), JDGData.from_raw(t, ei, x)
    assert data.num_nodes == j_data.num_nodes and data.num_edge_events == j_data.num_edge_events
    for name in ("time", "edge_index", "edge_x", "edge_time"):
        np.testing.assert_array_equal(getattr(data, name), getattr(j_data, name), err_msg=name)
    bounds = {"train": (0, 599), "val": (600, 799), "test": (800, 999)}
    for splits, j_splits in ((data.split(), j_data.split()),
                             (TGBSplit(bounds).apply(data), JTGBSplit(bounds).apply(j_data))):
        assert len(splits) == len(j_splits) == 3
        for s, js in zip(splits, j_splits):
            assert s.edge_global_offset == js.edge_global_offset
            for name in ("edge_time", "edge_index", "edge_x"):
                np.testing.assert_array_equal(getattr(s, name), getattr(js, name))
            g, jg = DGraph(s), JDGraph(js)
            assert (g.num_nodes, g.num_edge_events, g.edge_x_dim) == \
                   (jg.num_nodes, jg.num_edge_events, jg.edge_x_dim)
            np.testing.assert_array_equal(g.edge_dst, np.asarray(jg.edge_dst))
    tgb = DGData.from_raw(t, ei, x)
    tgb._split_strategy = TGBSplit(bounds)
    with pytest.raises(ValueError):
        tgb.split(TemporalSplit(100, 200))


def test_from_raw_validation():
    t, ei, x = raw_events(E=10)
    bad = ei.copy()
    bad[3, 1] = -1
    with pytest.raises(InvalidNodeIDError):
        DGData.from_raw(t, bad)
    with pytest.raises(ValueError):
        DGData.from_raw(t - 2000, ei)
    with pytest.raises(ValueError):
        DGData.from_raw(t, ei, x[:5])
    with pytest.raises(TypeError):
        DGData.from_raw(t.astype(np.float32), ei)
    with pytest.raises(EmptyGraphError):
        DGData.from_raw(t[:0], ei[:0])


@pytest.mark.parametrize("bounds", [
    {}, {"start_time": 200, "end_time": 650}, {"start_idx": 30, "end_idx": 250},
    {"start_time": 100, "end_time": 900, "start_idx": 50, "end_idx": 120},
    {"start_time": 990, "end_time": 995},
])
def test_storage_slices_match_jax(bounds):
    t, ei, x = raw_events(seed=2)
    g, jg = DGraph(DGData.from_raw(t, ei, x)), JDGraph(JDGData.from_raw(t, ei, x))
    sl, j_sl = DGSliceTracker(**bounds), JDGSliceTracker(**bounds)
    for got, want in zip(g._storage.get_edges(sl), jg._storage.get_edges(j_sl)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(g._storage.get_edge_x(sl), jg._storage.get_edge_x(j_sl))
    assert g._storage.get_nodes(sl) == jg._storage.get_nodes(j_sl)


@pytest.mark.parametrize("batch_size", [64, 100])
def test_device_edge_stream_matches_jax(batch_size):
    t, ei, x = raw_events(seed=1)
    _, val, _ = DGData.from_raw(t, ei, x).split()
    _, j_val, _ = JDGData.from_raw(t, ei, x).split()
    stream = DeviceEdgeStream(DGraph(val), batch_size, device="cpu")
    j_stream = JStream(JDGraph(j_val), batch_size)
    assert stream.num_batches == j_stream.num_batches >= 1
    for i in range(stream.num_batches):
        b, jb = stream.batch_at(i), j_stream.batch_at(jnp.int32(i))
        for name in ("edge_src", "edge_dst", "edge_time", "edge_valid", "edge_ids", "edge_x"):
            np.testing.assert_array_equal(getattr(b, name).numpy(), np.asarray(getattr(jb, name)),
                                          err_msg=f"{name} @ {i}")
    with pytest.raises(IndexError):
        stream.batch_at(stream.num_batches)


def test_batch_container():
    b = DGBatch(torch.arange(3), torch.arange(3), torch.zeros(3), neg=torch.ones(2))
    assert b.has("neg") and "neg" in b and not b.has("nbr_nids") and not b.has("edge_valid")
    c = b.replace(neg=None)
    assert not c.has("neg") and b.has("neg")
    d = b.to("cpu")
    assert d is not b and torch.equal(d.neg, b.neg)


def _pipelines(pkg_hooks, manager_cls, **dev):
    recency_cls, tgb_cls = pkg_hooks
    hm = manager_cls(keys=["val", "test"])
    hm.register_shared(recency_cls(10, [3], ["edge_src", "edge_dst", "neg"],
                                   ["edge_time", "edge_time", "neg_time"],
                                   edge_x_full=np.zeros((4, 2), np.float32), **dev))
    hm.register("val", tgb_cls(candidates=np.zeros((4, 2), np.int32), **dev))
    return hm


def test_hook_manager_orders_like_jax():
    hm = _pipelines((RecencyNeighborHook, TGBNegativeEdgeSamplerHook), HookManager, device="cpu")
    j_hm = _pipelines((JRecency, JTGB), JHookManager)
    hm.resolve_hooks("val")
    j_hm.resolve_hooks("val")
    order = [type(h).__name__ for h in hm._key_to_hooks["val"]]
    assert order == [type(h).__name__ for h in j_hm._key_to_hooks["val"]]
    assert order == ["TGBNegativeEdgeSamplerHook", "RecencyNeighborHook"]
    # "test" has no producer of neg: unresolvable in both packages.
    for manager in (hm, j_hm):
        with pytest.raises(Exception, match="not produced"):
            manager.resolve_hooks("test")
    hm2 = _pipelines((RecencyNeighborHook, TGBNegativeEdgeSamplerHook), HookManager, device="cpu")
    fn, states = hm2.as_transform("val", None)
    assert [s is None for s in states] == [False, False]
    with pytest.raises(UnresolvableHookDependenciesError):
        hm2.as_transform("test", None)
    with pytest.raises(BadHookProtocolError):
        hm2.register("val", object())
    with pytest.raises(KeyError):
        hm2.register("train", StatelessHook())
    batch = DGBatch(torch.tensor([1, 2, 3, -1], dtype=torch.int32),
                    torch.tensor([2, 3, 4, -1], dtype=torch.int32),
                    torch.tensor([5, 5, 6, 0], dtype=torch.int32),
                    torch.tensor([True, True, True, False]),
                    edge_ids=torch.tensor([0, 1, 2, -1], dtype=torch.int32))
    with pytest.raises(RuntimeError):
        hm2.execute_active_hooks(None, batch)
    with hm2.activate("val"):
        assert hm2.active_key == "val"
        with pytest.raises(RuntimeError):
            hm2.register("val", StatelessHook())
        eager = hm2.execute_active_hooks(None, batch.replace())
    assert hm2.active_key is None
    # The eager path and the exported transform of a fresh pipeline give the
    # same batch (hook state is updated in place, so not the same pipeline).
    fresh = _pipelines((RecencyNeighborHook, TGBNegativeEdgeSamplerHook), HookManager, device="cpu")
    fn3, states3 = fresh.as_transform("val", None)
    _, functional = fn3(states3, batch.replace())
    for name in ("neg", "neg_batch_list", "seed_nids", "nbr_nids", "nbr_edge_time"):
        a, b = getattr(eager, name), getattr(functional, name)
        a, b = (a[0], b[0]) if isinstance(a, list) else (a, b)
        assert torch.equal(a, b), name
    with pytest.raises(ValueError):
        hm2.adopt_states("val", [None])
    hm2.reset_state()
    assert all(h.state is None for h in hm2._key_to_hooks["val"])
