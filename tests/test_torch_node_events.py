"""The port's data layer with dynamic node features and types against the JAX package.

A stream with edge events (features and ``edge_type``), dynamic
node-feature events (``node_x_*``, some of their ids past the edges'
range, some at an edge's or a label's time), node-label events and
``node_type``, unsorted, goes through both packages. Equal element by
element, bit for bit (nothing here does arithmetic on a float):
``from_raw``'s timeline, masks and row order, ``num_nodes``; each split
strategy's splits; ``discretize``; ``DGraph`` slices and their properties;
every loader batch (event- and time-ordered) at both
``materialize_features`` settings; ``DeviceEventStream``'s windows; and
the batch and node analytics hooks' outputs on those batches (their float
statistics, ratios the two packages divide in other orders, within 1e-6
of the largest |value|, at least 1). The validation errors raise where
JAX's do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tgm_tpu import DGData as JDGData
from tgm_tpu import DGDataLoader as JLoader
from tgm_tpu import DGraph as JDGraph
from tgm_tpu import hooks as jhooks
from tgm_tpu.data.split import TemporalRatioSplit as JRatioSplit
from tgm_tpu.data.split import TemporalSplit as JTemporalSplit
from tgm_tpu.data.split import TGBSplit as JTGBSplit
from tgm_tpu.exceptions import InvalidNodeIDError as JInvalidNodeIDError
from tgm_tpu.train import DeviceEventStream as JEventStream
from tgm_tpu_torch import DGData, DGDataLoader, DGraph
from tgm_tpu_torch import hooks as phooks
from tgm_tpu_torch.core.batch import DGBatch
from tgm_tpu_torch.data.split import TemporalRatioSplit, TemporalSplit, TGBSplit
from tgm_tpu_torch.exceptions import InvalidNodeIDError
from tgm_tpu_torch.train import DeviceEventStream

N, E, X, L, DX, DE, C = 50, 400, 90, 60, 5, 3, 4
FIELDS = ("edge_src", "edge_dst", "edge_time", "edge_valid", "edge_ids") + DGBatch.FIELDS
DATA_FIELDS = ("time", "edge_mask", "edge_index", "edge_x", "edge_type", "node_x_mask",
               "node_x_nids", "node_x", "node_y_mask", "node_y_nids", "node_y",
               "static_node_x", "node_type", "edge_time", "node_x_time", "node_y_time")


def raw_events(seed=0, t_max=400, gap=(150, 210)):
    """Unsorted events of three kinds; the times [gap) hold labels and node
    features only (no edge), and some node-feature ids lie past the edges'
    (a label's may not lie past a split's range)."""
    rng = np.random.default_rng(seed)
    shift = lambda t: np.where((t >= gap[0]) & (t < gap[1]), t + (gap[1] - gap[0]), t)
    t = shift(rng.integers(0, t_max, E))
    ei = rng.integers(0, N - 4, (E, 2)).astype(np.int32)
    xt = rng.integers(0, t_max, X)
    xt[::4] = t[: len(xt[::4])]  # ties with edges
    xn = rng.integers(0, N, X)  # ids up to N - 1: past the edges' N - 5
    yt = rng.integers(0, t_max, L)
    yt[::3] = xt[: len(yt[::3])]  # ties with node features
    yt[-4:] = gap[0] + 7  # labels inside the edge gap
    yn = rng.integers(0, 10, L)  # ids every split's edges reach
    return dict(edge_time=t, edge_index=ei, edge_x=rng.normal(size=(E, DE)).astype(np.float32),
                edge_type=rng.integers(0, 7, E).astype(np.int32),
                node_x_time=xt, node_x_nids=xn.astype(np.int32),
                node_x=rng.normal(size=(X, DX)).astype(np.float32),
                node_y_time=yt, node_y_nids=yn.astype(np.int32),
                node_y=rng.random((L, C)).astype(np.float32),
                node_type=rng.integers(0, 3, N).astype(np.int32),
                static_node_x=rng.normal(size=(N, 2)).astype(np.float32))


def both(time_delta="s", **raw):
    return (DGData.from_raw(time_delta=time_delta, **raw),
            JDGData.from_raw(time_delta=time_delta, **raw))


def same(got, want, what):
    assert (got is None) == (want is None), what
    if want is not None:
        got = got.numpy() if hasattr(got, "numpy") and not isinstance(got, np.ndarray) else got
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=what)


def close_stat(got, want, what):
    """Exact for integers and bools; within 1e-6 * max(|want|, 1) for floats."""
    got, want = got.numpy(), np.asarray(want)
    if np.issubdtype(want.dtype, np.floating):
        tol = 1e-6 * max(float(np.abs(want).max(initial=0.0)), 1.0)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)
    else:
        same(got, want, what)


def assert_data_equal(d, jd, where=""):
    for f in DATA_FIELDS:
        same(getattr(d, f), getattr(jd, f), f"{f} {where}")
    assert (d.num_nodes, d.num_edge_events, d.num_events, d.edge_global_offset) == \
           (jd.num_nodes, jd.num_edge_events, jd.num_events, jd.edge_global_offset), where


def assert_batch_equal(b, jb, where="", fields=FIELDS):
    for f in fields:
        same(b.__dict__.get(f), getattr(jb, f, None), f"{f} {where}")


# ---------------------------------------------------------------------- #
def test_from_raw_orders_every_kind_like_jax():
    raw = raw_events()
    d, jd = both(**raw)
    assert_data_equal(d, jd)
    assert d.num_nodes == N > int(raw["edge_index"].max()) + 1  # node features widen it
    kinds = np.zeros(d.num_events, np.int8)
    kinds[d.node_x_mask], kinds[d.node_y_mask] = 1, 2
    same_t = d.time[1:] == d.time[:-1]
    # At equal times: edges, then node features, then labels.
    assert not np.any(same_t & (kinds[:-1] > kinds[1:]))
    assert np.any(same_t & (kinds[:-1] == 0) & (kinds[1:] == 1))
    assert np.any(same_t & (kinds[:-1] == 1) & (kinds[1:] == 2))
    # Each kind pre-sorted: the timeline needs no reordering within a kind.
    by_time = dict(raw)
    for kind, rows in (("edge", ("edge_index", "edge_x", "edge_type")),
                       ("node_x", ("node_x_nids", "node_x")), ("node_y", ("node_y_nids", "node_y"))):
        order = np.argsort(raw[f"{kind}_time"], kind="stable")
        for f in (f"{kind}_time",) + rows:
            by_time[f] = raw[f][order]
    assert_data_equal(*both(**by_time))
    assert_data_equal(d.clone(), jd.clone())


@pytest.mark.parametrize("strategy", ["temporal", "ratio", "ratio-skewed", "tgb"])
def test_splits_match_jax(strategy):
    d, jd = both(**raw_events(seed=1))
    p, j = {
        "temporal": (TemporalSplit(120, 300), JTemporalSplit(120, 300)),
        "ratio": (TemporalRatioSplit(), JRatioSplit()),
        "ratio-skewed": (TemporalRatioSplit(0.5, 0.3, 0.2), JRatioSplit(0.5, 0.3, 0.2)),
        "tgb": (TGBSplit({"train": (0, 199), "val": (200, 299), "test": (300, 500)}),
                JTGBSplit({"train": (0, 199), "val": (200, 299), "test": (300, 500)})),
    }[strategy]
    splits, j_splits = d.split(p), jd.split(j)
    assert len(splits) == len(j_splits) == 3
    for i, (s, js) in enumerate(zip(splits, j_splits)):
        assert_data_equal(s, js, f"split {i}")
        assert s.node_type is d.node_type and s.static_node_x is d.static_node_x  # shared


def test_split_drops_a_kind_masked_out_like_jax():
    raw = raw_events(seed=2)
    raw["node_x_time"] = np.full(X, 390)  # every node feature in the test range
    d, jd = both(**raw)
    for s, js in zip(d.split(TemporalSplit(120, 300)), jd.split(JTemporalSplit(120, 300))):
        assert_data_equal(s, js)
    assert d.split(TemporalSplit(120, 300))[0].node_x_mask is None


@pytest.mark.parametrize("unit", ["m", "h"])
def test_discretize_matches_jax(unit):
    raw = raw_events(seed=3, t_max=20_000, gap=(7_000, 9_000))
    raw["node_x_nids"][::5] = raw["node_x_nids"][0]  # repeats within a bucket
    d, jd = both(**raw)
    for s, js in ((d, jd), (d.split()[1], jd.split()[1])):
        got, want = s.discretize(unit), js.discretize(unit)
        assert_data_equal(got, want, unit)
    assert d.discretize(unit).num_events < d.num_events  # buckets merged events


@pytest.mark.parametrize("bounds", [("slice_events", 0, 120), ("slice_events", 200, 420),
                                    ("slice_time", 100, 260), ("slice_time", 150, 210)])
def test_slices_and_properties_match_jax(bounds):
    d, jd = both(**raw_events(seed=4))
    for g, jg in ((DGraph(d), JDGraph(jd)), (DGraph(d.split()[1]), JDGraph(jd.split()[1]))):
        v, jv = getattr(g, bounds[0])(*bounds[1:]), getattr(jg, bounds[0])(*bounds[1:])
        for f in ("start_time", "end_time", "num_nodes", "num_node_events", "num_node_labels",
                  "num_edge_events", "num_timestamps", "num_events", "node_x_dim", "node_y_dim",
                  "edge_x_dim", "static_node_x_dim"):
            assert getattr(v, f) == getattr(jv, f), f
        for f in ("edge_src", "edge_dst", "edge_time", "edge_x", "edge_type", "node_x_nids",
                  "node_x_time", "node_y_nids", "node_y_time", "static_node_x", "node_type"):
            same(getattr(v, f), getattr(jv, f), f)
        for f in ("node_x", "node_y"):
            got, want = getattr(v, f), getattr(jv, f)
            for a, b in zip(got, want):
                same(a, b, f)
        pads = dict(pad_edges_to=v.num_edge_events + 3, pad_node_x_to=v.num_node_events + 5,
                    pad_node_y_to=v.num_node_labels + 2)
        for feats in (True, False):
            b = v.materialize(materialize_features=feats, device="cpu", **pads)
            assert_batch_equal(b, jv.materialize(materialize_features=feats, **pads))
            assert b.has("num_node_labels") == feats
        with pytest.raises(ValueError):  # narrower than the slice
            v.materialize(pad_node_x_to=v.num_node_events - 1, device="cpu")


LOADER_CASES = [dict(batch_size=37), dict(batch_size=25, drop_last=True),
                dict(batch_size=9, batch_unit="s"), dict(batch_size=4, batch_unit="s",
                                                         on_empty=None),
                dict(batch_size=2, batch_unit="m", pad_multiple=1)]


def _jax_stream_batch(j_stream, i, feats):
    jb = j_stream.batch_at(jnp.int32(i))
    if not feats:  # the JAX stream keeps node windows whatever the loader materializes
        for f in ("node_x_time", "node_x_nids", "node_x", "node_x_valid", "node_y_time",
                  "node_y_nids", "node_y", "node_y_valid"):
            setattr(jb, f, None)
    return jb


@pytest.mark.parametrize("feats", [True, False], ids=["features", "no-features"])
@pytest.mark.parametrize("kw", LOADER_CASES)
def test_loader_and_stream_batches_match_jax(kw, feats):
    d, jd = both(**raw_events(seed=5))
    keeps_empty = "on_empty" in kw and kw["on_empty"] is None
    for data, j_data in ((d, jd), (d.split()[2], jd.split()[2])):
        loader = DGDataLoader(DGraph(data), materialize_features=feats, device="cpu", **kw)
        j_loader = JLoader(JDGraph(j_data), materialize_features=feats, **kw)
        p, jp = loader.plan(), j_loader.plan()
        assert (p.pad_edges, p.pad_node_x, p.pad_node_y) == \
               (jp.pad_edges, jp.pad_node_x, jp.pad_node_y)
        for f in ("starts", "edge_counts", "node_x_counts", "node_y_counts", "edge_offsets",
                  "node_x_offsets", "node_y_offsets"):
            same(getattr(p, f), getattr(jp, f), f)
        batches, j_batches = list(loader), list(j_loader)
        rows = np.arange(len(p)) if keeps_empty else loader.nonempty()
        assert len(batches) == len(j_batches) == len(rows)
        for i, (b, jb) in enumerate(zip(batches, j_batches)):
            assert_batch_equal(b, jb, f"batch {i}")
        # The stream serves the same windows, empty ones included.
        stream = DeviceEventStream(loader)
        j_stream = JEventStream(j_loader, include_features=feats)
        for i, b in zip(rows, batches):
            sb = stream.batch_at(int(i))
            assert_batch_equal(sb, b, f"stream {i}")  # edge_type too: JAX's stream lacks it
            assert_batch_equal(sb, _jax_stream_batch(j_stream, int(i), feats), f"stream {i}",
                               fields=[f for f in FIELDS if f != "edge_type"])
        if keeps_empty and data is d:
            assert len(loader.nonempty()) < len(p)  # the case holds empty windows


def test_analytics_hooks_read_node_events_like_jax():
    d, jd = both(**raw_events(seed=6))
    kw = dict(batch_size=9, batch_unit="s")
    tracked = [0, 3, 7, N - 1]
    ph, jh = phooks.BatchAnalyticsHook(), jhooks.BatchAnalyticsHook()
    pn = phooks.NodeAnalyticsHook(tracked, N, device="cpu")
    jn = jhooks.NodeAnalyticsHook(tracked, N)
    ps, js = pn.init_state(), jn.init_state()
    apply_b, apply_n = jax.jit(jh.apply), jax.jit(jn.apply)
    n_node_events = 0
    for b, jb in zip(DGDataLoader(DGraph(d), device="cpu", **kw), JLoader(JDGraph(jd), **kw)):
        _, pb = ph.apply(None, b)
        _, jb2 = apply_b(None, jb)
        for name in sorted(ph.produces):
            close_stat(getattr(pb, name), getattr(jb2, name), name)
        n_node_events += int(pb.num_node_events)
        ps, pb = pn.apply(ps, b)
        js, jb3 = apply_n(js, jb)
        for group in ("node_stats", "node_macro_stats", "edge_stats"):
            for k, want in getattr(jb3, group).items():
                close_stat(getattr(pb, group)[k], want, f"{group}.{k}")
    assert n_node_events == X


def _raises_like_jax(exc, j_exc, **raw):
    with pytest.raises(exc):
        DGData.from_raw(time_delta="s", **raw)
    with pytest.raises(j_exc):
        JDGData.from_raw(time_delta="s", **raw)


@pytest.mark.parametrize("case", ["nids-missing", "nids-shape", "pad-id", "feat-shape",
                                  "empty", "edge-type-shape", "edge-type-float",
                                  "node-type-short", "label-past-range", "time-count"])
def test_validation_raises_like_jax(case):
    raw = raw_events(seed=7)
    exc, j_exc = ValueError, ValueError
    if case == "nids-missing":
        raw["node_x_nids"] = None
    elif case == "nids-shape":
        raw["node_x_nids"] = raw["node_x_nids"][:-1]
    elif case == "pad-id":
        raw["node_x_nids"] = raw["node_x_nids"].copy()
        raw["node_x_nids"][3] = -1
        exc, j_exc = InvalidNodeIDError, JInvalidNodeIDError
    elif case == "feat-shape":
        raw["node_x"] = raw["node_x"][:, :, None]
    elif case == "empty":
        raw.update(node_x_time=np.empty(0, np.int64), node_x_nids=np.empty(0, np.int32),
                   node_x=np.empty((0, DX), np.float32))
    elif case == "edge-type-shape":
        raw["edge_type"] = raw["edge_type"][:-2]
    elif case == "edge-type-float":
        raw["edge_type"] = raw["edge_type"].astype(np.float32)
        exc, j_exc = TypeError, TypeError
    elif case == "node-type-short":
        num_nodes = DGData.from_raw(time_delta="s", **raw).num_nodes
        raw["node_type"] = raw["node_type"][: num_nodes - 1]
    elif case == "label-past-range":
        raw["node_y_nids"] = raw["node_y_nids"].copy()
        raw["node_y_nids"][0] = DGData.from_raw(time_delta="s", **raw).num_nodes  # one past
        exc, j_exc = InvalidNodeIDError, JInvalidNodeIDError
    elif case == "time-count":
        d, jd = both(**raw)
        for cls, data, err in ((DGData, d, ValueError), (JDGData, jd, ValueError)):
            with pytest.raises(err):
                cls(time_delta="s", time=data.time[:-1], edge_mask=data.edge_mask,
                    edge_index=data.edge_index, node_x_mask=data.node_x_mask,
                    node_x_nids=data.node_x_nids)
        return
    _raises_like_jax(exc, j_exc, **raw)
