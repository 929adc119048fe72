"""Discretization, the merged snapshot schedule and the snapshot windows
against the JAX package on the CPU, all exact.

* ``DGData.discretize`` bit-equal to JAX on numpy-seeded streams with
  duplicate (bucket, src, dst) edges, edge features, node labels
  (duplicate (bucket, node) pairs too) and node ids near 2^31; the
  same-delta clone; the event-ordered and finer-granularity errors;
  ``TimeDeltaDG("s", ticks)``'s ``convert`` and ``is_coarser_than``.
* ``plan_edge_max_times`` and ``merged_snapshot_schedule`` equal to JAX for
  several seeds, with ``apply_first=False``, with no snapshots and with
  empty batches; ``scanned_snapshot_epoch`` routes each step to its core.
* The snapshot loader's plan and the ``DeviceEventStream`` windows over a
  discretized graph equal JAX's, and a snapshot example's streams carry no
  edge features (``build_snapshot_linkpred`` strips them from each split).
"""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgm_tpu import DGData as JDGData
from tgm_tpu import DGDataLoader as JLoader
from tgm_tpu import DGraph as JDGraph
from tgm_tpu import TimeDeltaDG as JTD
from tgm_tpu.exceptions import EventOrderedConversionError as JEventOrdered
from tgm_tpu.train import DeviceEventStream as JEventStream
from tgm_tpu.train.snapshot import merged_snapshot_schedule as j_schedule
from tgm_tpu.train.snapshot import plan_edge_max_times as j_max_times
from tgm_tpu_torch import DGData, DGDataLoader, DGraph, TimeDeltaDG
from tgm_tpu_torch.exceptions import EventOrderedConversionError, InvalidDiscretizationError
from tgm_tpu_torch.examples._snapshot_common import build_snapshot_linkpred
from tgm_tpu_torch.examples.linkproppred import gclstm, gcn, roland, tgcn
from tgm_tpu_torch.train import DeviceEventStream
from tgm_tpu_torch.train.snapshot import (
    merged_snapshot_schedule,
    plan_edge_max_times,
    scanned_snapshot_epoch,
)


def stream(seed, E=300, big_ids=False, labels=True, edge_x=True):
    """Raw event arrays: few distinct pairs (so buckets hold duplicates),
    times in [0, 5,000) seconds, label events on a few nodes."""
    rng = np.random.default_rng(seed)
    base = 2**31 - 40 if big_ids else 0
    pairs = rng.integers(0, 12, (E, 2)) + base
    kw = dict(edge_time=np.sort(rng.integers(0, 5_000, E)), edge_index=pairs.astype(np.int64)
              if big_ids else pairs.astype(np.int32), time_delta="s")
    if edge_x:
        kw["edge_x"] = rng.normal(size=(E, 3)).astype(np.float32)
    if labels:
        L = 60
        kw.update(node_y_time=np.sort(rng.integers(0, 5_000, L)),
                  node_y_nids=(rng.integers(0, 6, L) + base).astype(np.int32),
                  node_y=rng.normal(size=(L, 2)).astype(np.float32))
    return kw


FIELDS = ("time", "edge_mask", "edge_index", "edge_x", "node_y_mask", "node_y_nids", "node_y",
          "static_node_x")


def same_data(p, j):
    for name in FIELDS:
        a, b = getattr(p, name), getattr(j, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert (p.time_delta.unit, p.time_delta.value) == (j.time_delta.unit, j.time_delta.value)


@pytest.mark.parametrize("seed,big_ids,labels,ticks", [
    (0, False, True, 100), (1, False, True, 777), (2, True, True, 250), (3, False, False, 60),
    (4, True, False, 3_600)])
def test_discretize_is_bit_equal_to_jax(seed, big_ids, labels, ticks):
    import warnings

    kw = stream(seed, big_ids=big_ids, labels=labels)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the int64 -> int32 downcast
        p, j = DGData.from_raw(**kw), JDGData.from_raw(**kw)
    sp, sj = p.discretize(TimeDeltaDG("s", ticks)), j.discretize(JTD("s", ticks))
    same_data(sp, sj)
    assert sp.num_edge_events < p.num_edge_events  # duplicates went
    # The string form and a coarser unit.
    same_data(p.discretize("h"), j.discretize("h"))


def test_discretize_same_delta_clones_and_raises_as_jax():
    kw = stream(0)
    p, j = DGData.from_raw(**kw), JDGData.from_raw(**kw)
    for delta in (None, TimeDeltaDG("s"), "s"):
        c = p.discretize(delta)
        same_data(c, j.discretize(None if delta is None else JTD("s")))
        assert c is not p and c.edge_index is not p.edge_index
    with pytest.raises(InvalidDiscretizationError):
        p.discretize("ms")
    er_kw = dict(kw, time_delta="r")
    with pytest.raises(EventOrderedConversionError):
        DGData.from_raw(**er_kw).discretize("s")
    with pytest.raises(JEventOrdered):
        JDGData.from_raw(**er_kw).discretize("s")
    with pytest.raises(EventOrderedConversionError):
        p.discretize("r")
    with pytest.raises(ValueError):
        p.discretize("h", reduce_op="last")


@pytest.mark.parametrize("ticks", [1, 60, 86_400, 100])
def test_snapshot_time_delta_algebra_matches_jax(ticks):
    for unit in ("s", "m", "h", "ms"):
        p, j = TimeDeltaDG("s", ticks), JTD("s", ticks)
        assert p.convert(unit) == j.convert(unit)
        assert p.convert(TimeDeltaDG(unit)) == j.convert(JTD(unit))
        assert p.is_coarser_than(unit) == j.is_coarser_than(unit)
        assert TimeDeltaDG(unit).is_coarser_than(p) == JTD(unit).is_coarser_than(j)
    assert TimeDeltaDG("s").convert(TimeDeltaDG("s", ticks)) == JTD("s").convert(JTD("s", ticks))


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("apply_first", [True, False])
def test_schedule_matches_jax(seed, apply_first):
    rng = np.random.default_rng(seed)
    n_snap, n_batch = int(rng.integers(1, 9)), int(rng.integers(1, 40))
    conversion = int(rng.integers(2, 20))
    snap_max = np.sort(rng.integers(0, 12, n_snap))
    batch_max = np.sort(rng.integers(0, conversion * 14, n_batch))
    got = merged_snapshot_schedule(snap_max, batch_max, conversion, apply_first=apply_first)
    want = j_schedule(snap_max, batch_max, conversion, apply_first=apply_first)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_schedule_without_snapshots_and_plan_max_times_with_empty_batches():
    for args in ((np.array([]), np.array([3, 7]), 5), (np.array([]), np.array([]), 5)):
        for a, b in zip(merged_snapshot_schedule(*args), j_schedule(*args)):
            assert np.array_equal(a, b)
    from types import SimpleNamespace

    plan = SimpleNamespace(edge_offsets=np.array([0, 3, 3, 3]),
                           edge_counts=np.array([3, 0, 2, 0]))
    times = np.array([1, 4, 9, 12, 30])
    got = plan_edge_max_times(plan, times)
    assert got.tolist() == [9, 0, 30, 0]
    assert np.array_equal(got, j_max_times(plan, times))


def _arr(x):
    return np.asarray(x.cpu()) if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("seed,ticks", [(0, 100), (1, 400), (2, 37)])
def test_snapshot_windows_match_jax(seed, ticks):
    """The snapshot loader's plan (empty snapshots kept by the stream), each
    window and the schedule over a split's discretized graph. The stream
    has a 3,000 s gap, so some snapshots are empty."""
    kw = stream(seed, labels=False)
    t = kw["edge_time"]
    kw["edge_time"] = np.where(t >= 1_500, t + 3_000, t)
    p_split = DGData.from_raw(**kw).split()[0]
    j_split = JDGData.from_raw(**kw).split()[0]
    sp, sj = p_split.discretize(TimeDeltaDG("s", ticks)), j_split.discretize(JTD("s", ticks))
    same_data(sp, sj)
    # The snapshot path reads no edge features: the port strips them from the
    # data, JAX's loader and stream switch them off.
    lp = DGDataLoader(DGraph(replace(sp, edge_x=None)), ticks, batch_unit="s", device="cpu")
    lj = JLoader(JDGraph(sj), ticks, batch_unit="s", materialize_features=False)
    a, b = lp.plan(), lj.plan()
    assert a.kind == b.kind and a.batch_size == b.batch_size == 1 and a.pad_edges == b.pad_edges
    for name in ("starts", "edge_counts", "edge_offsets"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    assert (a.edge_counts == 0).any()  # the windows include empty snapshots
    spt, sjt = DeviceEventStream(lp), JEventStream(lj, include_features=False)
    assert spt.num_batches == sjt.num_batches and spt.edge_x is None
    for i in range(spt.num_batches):
        bp, bj = spt.batch_at(i), sjt.batch_at(jnp.int32(i))
        for name in ("edge_src", "edge_dst", "edge_time", "edge_valid", "edge_ids"):
            assert np.array_equal(_arr(getattr(bp, name)), _arr(getattr(bj, name))), (i, name)
        assert not bp.has("edge_x")
    # The loader's own batches carry no features either (and skip empty snapshots).
    n_loaded = sum(1 for batch in lp if not batch.has("edge_x"))
    assert n_loaded == int((a.edge_counts > 0).sum())
    mp = plan_edge_max_times(a, sp.edge_time)
    assert np.array_equal(mp, j_max_times(b, sj.time[sj.edge_mask]))
    batch_max = np.sort(kw["edge_time"])[: p_split.num_edge_events][::50]
    for a_, b_ in zip(merged_snapshot_schedule(mp, batch_max, ticks),
                      j_schedule(mp, batch_max, ticks)):
        assert np.array_equal(a_, b_)


@pytest.mark.parametrize("example", [gcn, tgcn, gclstm, roland],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_snapshot_streams_carry_no_edge_features(example):
    """A snapshot example's event and snapshot streams serve the edges alone,
    for every split, while the caller's data keeps its features."""
    kw = stream(0, labels=False)
    data = DGData.from_raw(**kw)
    _, val, test = data.split()
    rng = np.random.default_rng(0)
    cands = tuple(rng.integers(0, 12, (d.num_edge_events, 4)) for d in (val, test))
    args = example.parse_args(["--bsize", "32", "--embed-dim", "8", "--snapshot-ticks", "400",
                           "--device", "cpu"])
    ctx = example.build(args, data=data, cands=cands)
    s = ctx.setup
    prog = build_snapshot_linkpred(args, s.train_data, s.num_nodes, ctx.snap_apply, ctx.init_rec,
                                   ctx.decoder, ctx.opt, s.val_data, s.test_data, s.val_cands,
                                   s.test_cands, ctx.neg_hook, s.device)
    assert sorted(prog.epochs) == ["test", "train", "val"]
    for split, ep in prog.epochs.items():
        assert ep.snap_stream.edge_x is None and ep.edge_stream.edge_x is None, split
        assert ep.snap_data.edge_x is None, split
        assert not ep.edge_stream.batch_at(0).has("edge_x"), split
        assert not ep.snap_stream.batch_at(0).has("edge_x"), split
    assert s.train_data.edge_x is not None and data.edge_x is not None


def test_scanned_snapshot_epoch_routes_each_step():
    kinds = np.array([0, 1, 1, 0, 1], np.int32)
    idxs = np.array([0, 0, 1, 1, 2], np.int32)
    snap_vals = torch.tensor([10.0, 20.0])
    batch_vals = torch.tensor([1.0, 2.0, 3.0])
    seen = []

    def edge_core(carry, bval, idx):
        seen.append(idx)
        return carry, (carry + bval, torch.tensor(1))

    epoch = scanned_snapshot_epoch(kinds, idxs, lambda i: snap_vals[i], lambda i: batch_vals[i],
                                   lambda c, s: c + s, edge_core)
    carry, a, b = epoch(torch.tensor(0.0))
    assert seen == [0, 1, 2]
    assert b.tolist() == [0.0, 1.0, 1.0, 0.0, 1.0] and b.dtype == torch.float32
    assert float(carry) == 30.0
    assert a.tolist() == [0.0, 11.0, 12.0, 0.0, 33.0]
