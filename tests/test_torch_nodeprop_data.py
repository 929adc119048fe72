"""The port's node-label data path against the JAX package's, exactly.

``DGData`` with label events (equal-time ties, the ``num_nodes`` rule),
both splits' label windows, ``DGraph`` slices and ``materialize``, the
``DGDataLoader``'s plans and eager batches (event- and time-ordered, empty
batches, ``on_empty``, ``drop_last``, ``pad_multiple``, hooks per batch),
``DeviceEventStream``'s batches and the synthetic dataset's label branch,
on the CPU. Integer fields and masks are compared bit for bit, and so are
the float fields: nothing here does arithmetic on them.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest

from examples._datasets import load_dataset as j_load_dataset
from tgm_tpu import DGData as JDGData
from tgm_tpu import DGDataLoader as JLoader
from tgm_tpu import DGraph as JDGraph
from tgm_tpu.data.split import TemporalSplit as JTemporalSplit
from tgm_tpu.data.split import TGBSplit as JTGBSplit
from tgm_tpu.exceptions import EmptyBatchError as JEmptyBatchError
from tgm_tpu.hooks import HookManager as JHookManager
from tgm_tpu.hooks import RecencyNeighborHook as JRecency
from tgm_tpu.train import DeviceEventStream as JEventStream
from tgm_tpu_torch import DGData, DGDataLoader, DGraph, TimeDeltaDG
from tgm_tpu_torch.data.split import TemporalSplit, TGBSplit
from tgm_tpu_torch.examples._datasets import load_dataset
from tgm_tpu_torch.exceptions import (
    EmptyBatchError,
    EventOrderedConversionError,
    InvalidDiscretizationError,
    InvalidNodeIDError,
)
from tgm_tpu_torch.hooks import HookManager, RecencyNeighborHook
from tgm_tpu_torch.train import DeviceEventStream

N, E, L, C, D = 40, 300, 70, 4, 3
BATCH_FIELDS = ("edge_src", "edge_dst", "edge_time", "edge_valid", "edge_ids", "edge_x",
                "node_y_time", "node_y_nids", "node_y", "node_y_valid")


def raw_events(seed=0, t_max=200, gap=None):
    """Unsorted edges and labels; a third of the labels share an edge's time.
    ``gap`` = (a, b) leaves the times [a, b) without any event."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, t_max, E)
    if gap is not None:
        t = np.where((t >= gap[0]) & (t < gap[1]), t + (gap[1] - gap[0]), t)
    ei = rng.integers(0, N, (E, 2)).astype(np.int32)
    ex = rng.normal(size=(E, D)).astype(np.float32)
    yt = rng.integers(0, t_max, L)
    yt[::3] = t[: len(yt[::3])]  # ties with edges: edges stay first
    if gap is not None:
        yt = np.where((yt >= gap[0]) & (yt < gap[1]), yt + (gap[1] - gap[0]), yt)
    yn = ei[rng.integers(0, E, L), 0]
    y = rng.random((L, C)).astype(np.float32)
    return dict(edge_time=t, edge_index=ei, edge_x=ex, node_y_time=yt, node_y_nids=yn, node_y=y)


def both(time_delta="s", **raw):
    return (DGData.from_raw(time_delta=time_delta, **raw),
            JDGData.from_raw(time_delta=time_delta, **raw))


def assert_data_equal(d, jd):
    for f in ("time", "edge_mask", "edge_index", "edge_x", "node_y_mask", "node_y_nids",
              "node_y", "edge_time", "node_y_time"):
        got, want = getattr(d, f), getattr(jd, f)
        assert (got is None) == (want is None), f
        if got is not None:
            np.testing.assert_array_equal(got, want, err_msg=f)
    assert (d.num_nodes, d.num_edge_events, d.num_events, d.edge_global_offset) == \
           (jd.num_nodes, jd.num_edge_events, jd.num_events, jd.edge_global_offset)


def assert_batch_equal(b, jb, where=""):
    for f in BATCH_FIELDS:
        want = getattr(jb, f)
        got = b.__dict__.get(f)
        assert (got is None) == (want is None), f"{f} {where}"
        if want is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"{f} {where}")


# ---------------------------------------------------------------------- #
def test_dgdata_with_labels_matches_jax():
    raw = raw_events()
    d, jd = both(**raw)
    assert_data_equal(d, jd)
    # Ties: at every time an edge and a label share, the edge comes first.
    kinds = np.zeros(d.num_events, np.int8)
    kinds[d.node_y_mask] = 2
    same = d.time[1:] == d.time[:-1]
    assert not np.any(same & (kinds[:-1] == 2) & (kinds[1:] == 0))
    assert np.any(same & (kinds[:-1] == 0) & (kinds[1:] == 2))
    assert isinstance(d.time_delta, TimeDeltaDG) and d.time_delta == TimeDeltaDG("s")


def test_num_nodes_counts_edge_ids_only():
    raw = raw_events()
    raw["edge_index"] = raw["edge_index"] % 30
    raw["node_y_nids"] = raw["node_y_nids"] % 30
    d, jd = both(**raw)
    assert d.num_nodes == jd.num_nodes == int(raw["edge_index"].max()) + 1
    raw["node_y_nids"] = raw["node_y_nids"].copy()
    raw["node_y_nids"][5] = d.num_nodes  # one past the edges' range
    with pytest.raises(InvalidNodeIDError):
        DGData.from_raw(**raw)
    with pytest.raises(Exception, match="outside the graph's node ID range"):
        JDGData.from_raw(**raw)
    raw["node_y_nids"][5] = -1
    with pytest.raises(InvalidNodeIDError):
        DGData.from_raw(**raw)


def test_label_and_static_validation():
    raw = raw_events()
    with pytest.raises(ValueError):
        DGData.from_raw(**dict(raw, node_y=raw["node_y"][:-1]))
    with pytest.raises(ValueError):
        DGData.from_raw(**dict(raw, node_y_nids=raw["node_y_nids"][:-1]))
    with pytest.raises(ValueError):
        DGData.from_raw(**raw, static_node_x=np.zeros((5, 2), np.float32))
    sx = np.arange(2 * N, dtype=np.float64).reshape(N, 2)
    with pytest.warns(UserWarning, match="Downcasting"):
        d = DGData.from_raw(**raw, static_node_x=sx)
    assert d.static_node_x.dtype == np.float32
    d, jd = both(**dict(raw, node_y=None))  # labels without values: ids and times only
    assert_data_equal(d, jd)


@pytest.mark.parametrize("strategy", ["temporal", "tgb"])
def test_split_label_windows_match_jax(strategy):
    raw = raw_events(seed=1)
    t = raw["edge_time"].copy()
    if strategy == "temporal":
        make = lambda cls: cls(val_time=120, test_time=160)
        starts, ends = (0, 120, 160), (120, 160, 10**9)
    else:
        bounds = {"train": (0, 119), "val": (120, 159), "test": (160, 199)}
        make = lambda cls: cls(bounds)
        starts, ends = (0, 120, 160), (119, 159, 199)
    # A label one tick before a split's start and one at a split's end.
    yt = raw["node_y_time"].copy()
    yt[:2], yt[2:4] = 119, 159
    raw = dict(raw, edge_time=t, node_y_time=yt)
    d, jd = both(**raw)
    splits = make(TemporalSplit if strategy == "temporal" else TGBSplit).apply(d)
    j_splits = make(JTemporalSplit if strategy == "temporal" else JTGBSplit).apply(jd)
    assert len(splits) == len(j_splits) == 3
    for s, js, lo, hi in zip(splits, j_splits, starts, ends):
        assert_data_equal(s, js)
        yt = s.node_y_time
        if strategy == "temporal":
            assert yt.min() >= lo and yt.max() < hi
        else:  # [start - 1, end): half-open, one tick early
            assert yt.min() >= lo - 1 and yt.max() < hi
    if strategy == "tgb":
        assert 119 in splits[1].node_y_time and 159 in splits[2].node_y_time
        assert 159 not in splits[1].node_y_time


def test_split_drops_all_masked_labels_with_a_warning(caplog):
    raw = raw_events(seed=2)
    raw["node_y_time"] = np.full(L, 10)  # every label falls in train
    d, jd = both(**raw)
    with caplog.at_level(logging.WARNING):
        splits = TemporalSplit(100, 150).apply(d)
    j_splits = JTemporalSplit(100, 150).apply(jd)
    for s, js in zip(splits, j_splits):
        assert_data_equal(s, js)
    assert splits[0].node_y_nids is not None
    assert splits[1].node_y_nids is None and splits[2].node_y_nids is None
    assert "masked out" in caplog.text


@pytest.mark.parametrize("bounds", [
    dict(kind="events", a=0, b=40), dict(kind="events", a=100, b=171),
    dict(kind="time", a=50, b=90), dict(kind="time", a=199, b=260),
])
def test_slices_and_materialize_match_jax(bounds):
    d, jd = both(**raw_events(seed=3))
    _, val, _ = d.split(TemporalSplit(80, 150))
    _, j_val, _ = jd.split(JTemporalSplit(80, 150))
    for g, jg in ((DGraph(d), JDGraph(jd)), (DGraph(val), JDGraph(j_val))):
        sl = "slice_events" if bounds["kind"] == "events" else "slice_time"
        v, jv = getattr(g, sl)(bounds["a"], bounds["b"]), getattr(jg, sl)(bounds["a"], bounds["b"])
        for f in ("start_time", "end_time", "num_events", "num_node_labels", "node_y_dim",
                  "num_edge_events", "num_nodes"):
            assert getattr(v, f) == getattr(jv, f), f
        pad_e, pad_y = v.num_edge_events + 5, v.num_node_labels + 3
        b = v.materialize(pad_edges_to=pad_e, pad_node_y_to=pad_y, device="cpu")
        jb = jv.materialize(pad_edges_to=pad_e, pad_node_y_to=pad_y)
        assert_batch_equal(b, jb)
        assert b.num_node_labels == v.num_node_labels
        unpadded = v.materialize(device="cpu")
        assert bool(unpadded.edge_valid.all()) and bool(unpadded.node_y_valid.all())
        with pytest.raises(ValueError):  # narrower than the slice
            v.materialize(pad_edges_to=pad_e, pad_node_y_to=pad_y - 4, device="cpu")


LOADER_CASES = [
    dict(batch_size=37),  # event-ordered
    dict(batch_size=50, drop_last=True),
    dict(batch_size=20, pad_multiple=1),
    dict(batch_size=7, batch_unit="s"),  # time-ordered
    dict(batch_size=3, batch_unit="s", on_empty=None),  # keeps the empty windows
    dict(batch_size=2, batch_unit="m", drop_last=True),
]


@pytest.mark.parametrize("kw", LOADER_CASES)
def test_loader_plans_and_batches_match_jax(kw):
    raw = raw_events(seed=4, t_max=400, gap=(100, 160))  # a gap: empty time windows
    d, jd = both(**raw)
    for data, j_data in ((d, jd), (d.split()[1], jd.split()[1])):
        loader = DGDataLoader(DGraph(data), device="cpu", **kw)
        j_loader = JLoader(JDGraph(j_data), **kw)
        p, jp = loader.plan(), j_loader.plan()
        assert (p.kind, p.batch_size, p.pad_edges, p.pad_node_y) == \
               (jp.kind, jp.batch_size, jp.pad_edges, jp.pad_node_y)
        for f in ("starts", "edge_counts", "node_y_counts", "edge_offsets", "node_y_offsets"):
            np.testing.assert_array_equal(getattr(p, f), getattr(jp, f), err_msg=f)
        batches, j_batches = list(loader), list(j_loader)
        assert len(batches) == len(j_batches) >= (data is d)
        for i, (b, jb) in enumerate(zip(batches, j_batches)):
            assert_batch_equal(b, jb, f"batch {i}")
            assert b.num_node_labels == int(np.asarray(jb.node_y_valid).sum())
    if kw.get("batch_unit") == "s" and kw.get("on_empty", "skip") is None:
        assert (p.edge_counts + p.node_y_counts == 0).any()  # the case holds empty batches


def test_loader_on_empty_raise_and_unit_errors():
    raw = raw_events(seed=4, t_max=400, gap=(100, 160))
    d, jd = both(**raw)
    with pytest.raises(EmptyBatchError):
        list(DGDataLoader(DGraph(d), 3, batch_unit="s", on_empty="raise", device="cpu"))
    with pytest.raises(JEmptyBatchError):
        list(JLoader(JDGraph(jd), 3, batch_unit="s", on_empty="raise"))
    skipped = DGDataLoader(DGraph(d), 3, batch_unit="s", device="cpu")
    assert len(list(skipped)) < len(skipped)
    r, _ = both(time_delta="r", **raw)
    with pytest.raises(EventOrderedConversionError):
        DGDataLoader(DGraph(r), 3, batch_unit="s", device="cpu")
    m, _ = both(time_delta="m", **raw)
    with pytest.raises(InvalidDiscretizationError):
        DGDataLoader(DGraph(m), 3, batch_unit="s", device="cpu")
    with pytest.raises(ValueError):
        DGDataLoader(DGraph(d), 0, device="cpu")
    with pytest.raises(ValueError):
        DGDataLoader(DGraph(d), 3, on_empty="bogus", device="cpu")


@pytest.mark.parametrize("kw", [dict(batch_size=37), dict(batch_size=3, batch_unit="s")])
def test_loader_runs_hooks_per_batch_like_jax(kw):
    """The recency hook seeded by the label nodes, in the loader's loop:
    every product equal to the JAX hook's."""
    d, jd = both(**raw_events(seed=5, t_max=400, gap=(100, 160)))
    hm, jhm = HookManager(keys=["all"]), JHookManager(keys=["all"])
    hm.register_shared(RecencyNeighborHook(N, [4, 3], ["node_y_nids"], ["node_y_time"],
                                           edge_dim=D, device="cpu"))
    jhm.register_shared(JRecency(N, [4, 3], ["node_y_nids"], ["node_y_time"], edge_dim=D))
    with hm.activate("all"), jhm.activate("all"):
        pairs = zip(DGDataLoader(DGraph(d), hook_manager=hm, device="cpu", **kw),
                    JLoader(JDGraph(jd), hook_manager=jhm, **kw))
        n = 0
        for b, jb in pairs:
            for f in ("seed_nids", "seed_times", "nbr_nids", "nbr_edge_time", "nbr_edge_x"):
                for hop, (got, want) in enumerate(zip(getattr(b, f), getattr(jb, f))):
                    np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                                  err_msg=f"{f}[{hop}] @ {n}")
            n += 1
    assert n > 3


@pytest.mark.parametrize("kw", [dict(batch_size=37), dict(batch_size=3, batch_unit="s"),
                                dict(batch_size=11, batch_unit="s", pad_multiple=1)])
def test_device_event_stream_matches_jax(kw):
    d, jd = both(**raw_events(seed=6, t_max=400, gap=(100, 160)))
    for data, j_data in zip(d.split(), jd.split()):
        loader = DGDataLoader(DGraph(data), device="cpu", **kw)
        stream = DeviceEventStream(loader)
        j_stream = JEventStream(JLoader(JDGraph(j_data), **kw))
        assert stream.num_batches == j_stream.num_batches == len(loader.plan())
        counts = loader.plan().node_y_counts
        for i in range(stream.num_batches):
            b = stream.batch_at(i)
            assert_batch_equal(b, j_stream.batch_at(jnp.int32(i)), f"batch {i}")
            assert b.num_node_labels == counts[i]
        np.testing.assert_array_equal(stream.edge_x.numpy(), np.asarray(j_stream.edge_x))
        with pytest.raises(IndexError):
            stream.batch_at(stream.num_batches)
    # The stream's batches are the loader's, empty ones included.
    loader = DGDataLoader(DGraph(d), 3, batch_unit="s", on_empty=None, device="cpu")
    stream = DeviceEventStream(loader)
    for i, b in enumerate(loader):
        assert_batch_equal(stream.batch_at(i), _as_jax(b), f"batch {i}")


def _as_jax(b):
    """A port batch's fields as numpy, for ``assert_batch_equal``."""
    class _B:
        pass
    out = _B()
    for f in BATCH_FIELDS:
        v = b.__dict__.get(f)
        setattr(out, f, None if v is None else v.numpy())
    return out


def test_synthetic_node_labels_match_jax():
    data, vc, tc = load_dataset("synthetic-120-800", node_label_classes=4)
    j_data, jvc, jtc = j_load_dataset("synthetic-120-800", node_label_classes=4)
    assert_data_equal(data, j_data)
    np.testing.assert_array_equal(vc, jvc)
    np.testing.assert_array_equal(tc, jtc)
    plain, pvc, _ = load_dataset("synthetic-120-800")
    np.testing.assert_array_equal(plain.edge_index, data.edge_index)  # no extra draws
    np.testing.assert_array_equal(pvc, vc)
    assert data.node_y.shape == (len(range(0, 800 - 6, 20)), 4)
    for s, js in zip(data.split(), j_data.split()):
        assert_data_equal(s, js)
