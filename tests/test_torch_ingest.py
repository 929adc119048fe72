"""Ingest and utilities of the port against the JAX package.

``DGData.from_tgb`` (tgbl, tgbn, tkgl, thgl) and ``DGData.from_tgb_seq``
run in both packages under the same stub ``tgb`` / ``tgb_seq`` modules as
``tests/test_tgb_loaders.py`` uses (the packages are not installed), and
the two ``DGData`` compare field by field (values and dtypes), time delta,
split strategy and the three splits included. ``from_pandas`` and
``from_csv`` do the same on the same tables. Then the TGB branch of the
examples' ``load_dataset`` and the TGB-Seq script's loader,
``seed_everything``, and the logging module: its records disabled and
enabled, against the JAX module's where both emit one.
"""

import json
import logging
import random
import sys
import types

import numpy as np
import pandas as pd
import pytest
import torch

from tgm_tpu import DGData as JDGData
from tgm_tpu.util import logging as jlog
from tgm_tpu_torch import DGData
from tgm_tpu_torch.examples import _datasets
from tgm_tpu_torch.examples.linkproppred.tgb_seq import edgebank as seq_script
from tgm_tpu_torch.util import logging as plog
from tgm_tpu_torch.util import get_seed, seed_everything

FIELDS = ("time", "edge_mask", "edge_index", "edge_x", "node_x_mask", "node_x_nids", "node_x",
          "node_y_mask", "node_y_nids", "node_y", "static_node_x", "edge_type", "node_type")


def assert_same_data(d, jd, where=""):
    for f in FIELDS:
        got, want = getattr(d, f), getattr(jd, f)
        assert (got is None) == (want is None), f"{f} {where}"
        if want is not None:
            assert got.dtype == want.dtype, f"{f} {where}: {got.dtype} vs {want.dtype}"
            np.testing.assert_array_equal(got, want, err_msg=f"{f} {where}")
    assert (d.time_delta.unit, d.time_delta.value) == (jd.time_delta.unit, jd.time_delta.value)
    assert (d.num_nodes, d.num_edge_events, d.num_events, d.edge_global_offset) == \
           (jd.num_nodes, jd.num_edge_events, jd.num_events, jd.edge_global_offset), where


def assert_same_splits(d, jd):
    assert d._split_strategy.split_bounds == jd._split_strategy.split_bounds
    for name, a, b in zip(("train", "val", "test"), d.split(), jd.split()):
        assert_same_data(a, b, name)


def _masks(E, train_end, val_end):
    idx = np.arange(E)
    return idx < train_end, (idx >= train_end) & (idx < val_end), idx >= val_end


def _install_tgb(monkeypatch, link=None, node=None):
    mods = {name: types.ModuleType(name) for name in (
        "tgb", "tgb.linkproppred", "tgb.linkproppred.dataset", "tgb.nodeproppred",
        "tgb.nodeproppred.dataset")}
    mods["tgb.linkproppred.dataset"].LinkPropPredDataset = link
    mods["tgb.nodeproppred.dataset"].NodePropPredDataset = node
    for name, m in mods.items():
        monkeypatch.setitem(sys.modules, name, m)


def _dataset(name, **full_data):
    E = len(full_data["timestamps"])
    tr, va, te = _masks(E, int(E * 0.6), int(E * 0.8))
    node_feat = np.random.default_rng(2).normal(size=(9, 3)) if name.startswith("tgbl") else None

    class Fake:
        def __init__(self, name):
            self.full_data = full_data
            self.train_mask, self.val_mask, self.test_mask = tr, va, te
            self.node_feat = node_feat
            self.node_type = np.arange(9) % 3

    return Fake


def tgb_case(name):
    rng = np.random.default_rng(0)
    E = 40
    t = np.sort(rng.integers(5, 200, E))
    d = dict(sources=rng.integers(0, 9, E), destinations=rng.integers(0, 9, E), timestamps=t,
             edge_feat=rng.normal(size=(E, 4)))
    if name.startswith("tkgl"):
        d.update(timestamps=np.repeat(t[: E // 2], 2), edge_feat=rng.normal(size=(E // 2, 4)),
                 edge_type=rng.integers(0, 5, E))
    if name.startswith("thgl"):
        d.update(edge_feat=None, edge_type=rng.integers(0, 3, E))
    if name.startswith("tgbn"):
        d.update(edge_feat=None, node_label_dict={
            int(t[3]): {0: rng.random(3), 4: rng.random(3)},
            int(t[20]): {2: rng.random(3)},
            int(t[-1]) + 50: {1: rng.random(3)},  # past the last edge: dropped
        })
    return d


@pytest.mark.parametrize("name", ["tgbl-wiki", "tgbn-trade", "tkgl-polecat", "thgl-software"])
def test_from_tgb_matches_jax(monkeypatch, name):
    cls = _dataset(name, **tgb_case(name))
    if name.startswith("tgbn"):
        _install_tgb(monkeypatch, node=lambda name: cls(name))
    else:
        _install_tgb(monkeypatch, link=lambda name: cls(name))
    d, jd = DGData.from_tgb(name), JDGData.from_tgb(name)
    assert_same_data(d, jd)
    assert_same_splits(d, jd)
    if name.startswith("tgbn"):
        assert d.node_y.shape == (3, 3)


def test_from_tgb_errors_like_jax(monkeypatch):
    _install_tgb(monkeypatch, link=lambda name: None, node=lambda name: None)
    for f in (DGData.from_tgb, JDGData.from_tgb):
        with pytest.raises(ValueError, match="Unknown TGB dataset"):
            f("foo-bar")
    for m in [m for m in sys.modules if m == "tgb" or m.startswith("tgb.")]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, "tgb", None)  # import fails as if not installed
    for f in (DGData.from_tgb, JDGData.from_tgb):
        with pytest.raises(ImportError, match="py-tgb"):
            f("tgbl-wiki")


def _install_tgb_seq(monkeypatch, E=30):
    rng = np.random.default_rng(1)
    tr, va, te = _masks(E, 20, 25)

    class FakeSeq:
        def __init__(self, name, root=None):
            self.src_node_ids = rng.integers(0, 7, E)
            self.dst_node_ids = rng.integers(0, 7, E)
            self.node_interact_times = np.sort(rng.integers(1, 99, E)).astype(np.float64)
            self.edge_features = rng.normal(size=(E, 2))
            self.node_features = None
            self.train_mask, self.val_mask, self.test_mask = tr, va, te

    dl = types.ModuleType("tgb_seq.LinkPred.dataloader")
    # Each call draws anew from rng: hand both packages the same instance.
    inst = FakeSeq("GoogleLocal")
    dl.TGBSeqLoader = lambda name, root=None: inst
    for name in ("tgb_seq", "tgb_seq.LinkPred"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    monkeypatch.setitem(sys.modules, "tgb_seq.LinkPred.dataloader", dl)


def test_from_tgb_seq_matches_jax(monkeypatch):
    _install_tgb_seq(monkeypatch)
    d, jd = DGData.from_tgb_seq("GoogleLocal"), JDGData.from_tgb_seq("GoogleLocal")
    assert_same_data(d, jd)
    assert_same_splits(d, jd)


def test_example_loaders_take_tgb_names(monkeypatch):
    """``load_dataset`` loads a TGB name with no candidate arrays, and the
    TGB-Seq script's loader goes through ``from_tgb_seq``."""
    cls = _dataset("tgbl-wiki", **tgb_case("tgbl-wiki"))
    _install_tgb(monkeypatch, link=lambda name: cls(name))
    data, val_c, test_c = _datasets.load_dataset("tgbl-wiki")
    assert val_c is None and test_c is None
    assert_same_data(data, JDGData.from_tgb("tgbl-wiki"))
    _install_tgb_seq(monkeypatch)
    data, val_c, test_c = seq_script.load_seq("GoogleLocal")
    assert val_c is None and test_c is None
    assert_same_data(data, JDGData.from_tgb_seq("GoogleLocal"))
    data, val_c, _ = seq_script.load_seq("synthetic-50-300")
    assert data.num_edge_events == 300 and val_c.shape[1] == 20


def _tables():
    edges = pd.DataFrame({"u": [0, 1, 2, 2], "v": [1, 2, 0, 3], "t": [30, 10, 20, 20],
                          "w1": [0.1, 0.2, 0.3, 0.4], "w2": [1.0, 2.0, 3.0, 4.0],
                          "etype": [0, 1, 0, 2]})
    nodes = pd.DataFrame({"nid": [0, 2, 3], "t": [15, 25, 10], "f": [5.0, 6.0, 7.0]})
    labels = pd.DataFrame({"nid": [1, 3], "t": [22, 20], "y1": [0.7, 0.1], "y2": [0.3, 0.9]})
    static = pd.DataFrame({"s1": [1.0, 2.0, 3.0, 4.0], "ntype": [0, 0, 1, 1]})
    return edges, nodes, labels, static


KW = dict(edge_src_col="u", edge_dst_col="v", edge_time_col="t", edge_x_col=["w1", "w2"],
          edge_type_col="etype", node_x_nids_col="nid", node_x_time_col="t", node_x_col=["f"],
          node_y_nids_col="nid", node_y_time_col="t", node_y_col=["y1", "y2"],
          static_node_x_col=["s1"], node_type_col="ntype", time_delta="s")


def test_from_pandas_matches_jax():
    edges, nodes, labels, static = _tables()
    frames = dict(edge_df=edges, node_x_df=nodes, node_y_df=labels, static_node_x_df=static)
    with pytest.warns(UserWarning):
        d = DGData.from_pandas(**frames, **KW)
    jd = JDGData.from_pandas(**frames, **KW)
    assert_same_data(d, jd)
    # Only the edges, and a frame without its id / time columns.
    d = DGData.from_pandas(edges, "u", "v", "t")
    assert_same_data(d, JDGData.from_pandas(edges, "u", "v", "t"))
    for f in (DGData.from_pandas, JDGData.from_pandas):
        with pytest.raises(ValueError, match="without node id / time columns"):
            f(edges, "u", "v", "t", node_y_df=labels)
        with pytest.raises(ValueError, match="static_node_x_col / node_type_col"):
            f(edges, "u", "v", "t", static_node_x_df=static)


def test_from_csv_matches_jax(tmp_path):
    paths = {}
    for name, df in zip(("edge", "node_x", "node_y", "static_node_x"), _tables()):
        paths[f"{name}_file_path"] = tmp_path / f"{name}.csv"
        df.to_csv(paths[f"{name}_file_path"], index=False)
    d = DGData.from_csv(**paths, **KW)
    jd = JDGData.from_csv(**paths, **KW)
    assert_same_data(d, jd)
    np.testing.assert_array_equal(d.time, [10, 10, 15, 20, 20, 20, 22, 25, 30])


def test_seed_everything_seeds_random_numpy_and_torch():
    seed_everything(7)
    assert get_seed() == 7
    draws = (random.random(), float(np.random.rand()), torch.rand(1).item())
    random.seed(7)
    np.random.seed(7)
    torch.manual_seed(7)
    assert draws == (random.random(), float(np.random.rand()), torch.rand(1).item())
    seed_everything(8)
    assert get_seed() == 8


@pytest.fixture
def port_logger(monkeypatch):
    """The port's logger with a record-keeping handler; the module's flag
    and the logger's handlers and level are put back after."""
    logger = logging.getLogger("tgm_tpu_torch")
    monkeypatch.setattr(logger, "handlers", list(logger.handlers))
    monkeypatch.setattr(plog, "_logging_enabled", plog._logging_enabled)
    level = logger.level
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record)

    yield logger, records, Keep(level=logging.DEBUG)
    logger.setLevel(level)


def _json(records):
    return [json.loads(r.getMessage()) for r in records if r.getMessage().startswith("{")]


def test_logging_disabled_emits_nothing(port_logger, monkeypatch):
    logger, records, keep = port_logger
    monkeypatch.setattr(plog, "_logging_enabled", False)
    logger.addHandler(keep)
    f = plog.log_latency(lambda x: x + 1)
    g = plog.log_device_mem(lambda x: x * 2)
    assert f(1) == 2 and g(2) == 4
    assert plog.is_logging_enabled() is False
    assert records == []


def test_logging_enabled_records_like_jax(port_logger, tmp_path):
    logger, records, keep = port_logger
    plog.enable_logging(log_file_path=str(tmp_path / "log" / "run.log"))
    assert plog.is_logging_enabled()
    logger.setLevel(logging.DEBUG)
    logger.addHandler(keep)

    @plog.log_latency
    def work(x):
        return x + 1

    assert work(1) == 2
    # A call on CPU tensors touches no card: no memory record.
    assert torch.equal(plog.log_device_mem(lambda x: x * 2)(torch.ones(2)), torch.full((2,), 2.0))
    plog.log_metric("val_mrr", 0.5, epoch=1)
    plog.log_metrics_dict({"a": 1234567, "b": np.float32(2.5)}, prefix="p/")
    data = DGData.from_raw(np.array([1, 2, 30]), np.array([[0, 1], [1, 2], [2, 0]], np.int32),
                           time_delta="s")
    data.discretize("m")
    recs = _json(records)
    assert [r["metric"] for r in recs] == ["latency_test_logging_enabled_records_like_jax.<locals>"
                                           ".work", "val_mrr", "p/a", "p/b",
                                           "latency_DGData.discretize"]
    assert recs[1] == {"metric": "val_mrr", "value": 0.5, "epoch": 1}
    assert recs[3]["value"] == 2.5 and recs[0]["unit"] == "s" and recs[0]["value"] >= 0
    infos = [r.getMessage() for r in records if r.levelno == logging.INFO]
    assert infos == ["val_mrr = 0.5000", "p/a = 1.23M", "p/b = 2.5000"]
    assert (tmp_path / "log" / "run.log").exists()


@pytest.mark.parametrize("v", [0, 7, 2.5, 1234, 1234567, -2.5e9, 3e12, float("nan"), "x",
                               np.float32(0.125), None])
def test_pretty_number_format_like_jax(v):
    assert plog.pretty_number_format(v) == jlog.pretty_number_format(v)
