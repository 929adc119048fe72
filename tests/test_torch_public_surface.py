"""The rest of the port's public surface against the JAX package.

* Every name of every JAX ``__all__`` (and every public exception and
  constant) is present in the port, apart from the names ROADMAP.md leaves
  out with a reason; ``parallel`` included (ROADMAP item 10d).
* ``HookManager.collect_states`` / ``load_states`` / ``set_active_hooks`` /
  ``__str__``, ``DGBatch.num_valid_edges``, ``BaseDGHook.get_batch_attribute``,
  the storage's ``get_nbrs`` and the backend registry, on the cases of the
  JAX package's own tests, against the JAX package.
* The three analytics examples print what the JAX examples print.
"""

import importlib
import pkgutil
import re
import sys

import numpy as np
import pytest
import torch

import tgm_tpu
import tgm_tpu.constants as jconstants
import tgm_tpu.exceptions as jexceptions
from tgm_tpu import DGData as JDGData
from tgm_tpu import DGDataLoader as JDGDataLoader
from tgm_tpu import DGraph as JDGraph
from tgm_tpu.hooks import HookManager as JHookManager
from tgm_tpu.hooks import RecencyNeighborHook as JRecency
from tgm_tpu.hooks import StatelessHook as JStatelessHook
from tgm_tpu_torch import PADDED_NODE_ID, DGData, DGDataLoader, DGraph
from tgm_tpu_torch import constants, exceptions
from tgm_tpu_torch.core import (
    DGStorage,
    DGStorageArrayBackend,
    DGStorageBackends,
    DGStorageBase,
    get_dg_storage_backend,
    set_dg_storage_backend,
)
from tgm_tpu_torch.hooks import HookManager, RandomNegativeEdgeSamplerHook, RecencyNeighborHook
from tgm_tpu_torch.hooks import StatelessHook

# JAX names the port leaves out, with ROADMAP.md's reasons ("Not queued").
LEFT_OUT = {
    "tgm_tpu.util": {"fork_key"},
    "tgm_tpu.train": {"tncn_train_scores_occurrence"},
    "tgm_tpu.train.tncn_pipeline": {"tncn_train_scores_occurrence"},
}
# Still to port: nothing (ROADMAP item 10d, the last, is ported).
NOT_YET = ()
# The Pallas functions' counterparts are the port's kernel wrappers.
RENAMED = {"tgm_tpu.ops.pallas": "tgm_tpu_torch.ops"}


def jax_modules_with_all():
    names = ["tgm_tpu"] + [m.name for m in pkgutil.walk_packages(tgm_tpu.__path__, "tgm_tpu.")]
    for name in sorted(names):
        if name.startswith(NOT_YET):
            continue
        mod = importlib.import_module(name)
        if hasattr(mod, "__all__"):
            yield name, mod


def test_every_jax_all_is_matched_by_the_port():
    missing, checked = [], 0
    for name, jmod in jax_modules_with_all():
        pname = RENAMED.get(name, name.replace("tgm_tpu", "tgm_tpu_torch", 1))
        names = set(jmod.__all__) - LEFT_OUT.get(name, set())
        if not names:
            continue
        pmod = importlib.import_module(pname)
        missing += [f"{pname}.{n}" for n in sorted(names) if not hasattr(pmod, n)]
        if pname not in RENAMED.values():
            exported = set(getattr(pmod, "__all__", ()))
            missing += [f"{pname}.__all__ lacks {n}" for n in sorted(names - exported)]
        checked += 1
    assert not missing, missing
    assert checked >= 20  # the JAX modules with an __all__, parallel included


def test_exceptions_and_constants_are_all_there():
    for n in dir(jexceptions):
        obj = getattr(jexceptions, n)
        if isinstance(obj, type) and issubclass(obj, Exception):
            assert issubclass(getattr(exceptions, n), exceptions.TGMError) or n == "TGMError"
    for n in dir(jconstants):
        if n.isupper():
            assert getattr(constants, n) == getattr(jconstants, n), n


# ---------------------------------------------------------------------- #
# Hook manager, batch and hook helpers
# ---------------------------------------------------------------------- #
def tiny(pkg_data, pkg_graph, time_delta="r"):
    edge_time = np.array([1, 1, 2, 5, 5, 8, 9, 20], dtype=np.int64)
    edge_index = np.array(
        [[0, 1], [1, 2], [2, 3], [3, 0], [1, 3], [0, 2], [2, 1], [3, 1]], dtype=np.int64)
    edge_x = np.arange(16, dtype=np.float32).reshape(8, 2)
    return pkg_graph(pkg_data.from_raw(edge_time=edge_time, edge_index=edge_index,
                                       edge_x=edge_x, time_delta=time_delta))


def test_hook_state_round_trip_matches_jax():
    dg, jdg = tiny(DGData, DGraph), tiny(JDGData, JDGraph)
    hm, jhm = HookManager(keys=["train", "val"]), JHookManager(keys=["train", "val"])
    hm.register("train", RecencyNeighborHook(4, [2], ["edge_src"], ["edge_time"], device="cpu"))
    jhm.register("train", JRecency(4, [2], ["edge_src"], ["edge_time"]))
    hm.register_shared(RandomNegativeEdgeSamplerHook(0, 4, device="cpu"))
    jhm.register_shared(tgm_tpu.hooks.RandomNegativeEdgeSamplerHook(0, 4))
    with hm.activate("train"):
        hm.execute_active_hooks(dg, dg.materialize(pad_edges_to=8, device="cpu"))
    with jhm.activate("train"):
        jhm.execute_active_hooks(jdg, jdg.materialize(pad_edges_to=8))
    states, jstates = hm.collect_states(), jhm.collect_states()
    assert states["keyed"]["train"]
    assert states["shared"].keys() == jstates["shared"].keys()
    assert {k: v.keys() for k, v in states["keyed"].items()} == \
        {k: v.keys() for k, v in jstates["keyed"].items()}
    (name, ring), = states["keyed"]["train"].items()
    assert name == "1:RecencyNeighborHook"
    for got, want in zip(ring, jstates["keyed"]["train"][name]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    saved = [t.clone() for t in ring]
    with hm.activate("train"):  # a second batch moves the ring on
        hm.execute_active_hooks(dg, dg.materialize(pad_edges_to=8, device="cpu"))
    hook = hm._key_to_hooks["train"][1]
    assert not all(torch.equal(a, b) for a, b in zip(hook.state, saved))
    hm.load_states({"shared": {}, "keyed": {"train": {name: saved}}})
    assert hook.state is saved
    hm.load_states({})  # names that match nothing leave every state alone
    assert hook.state is saved


def test_set_active_hooks_and_activate_restore_the_previous_key():
    hm = HookManager(keys=["a", "b"])
    hm.set_active_hooks("a")
    with hm.activate("b"):
        assert hm.active_key == "b"
    assert hm.active_key == "a"
    with pytest.raises(KeyError):
        hm.set_active_hooks("c")


def _sorted_sets(text):
    return re.sub(r"\{([^{}]*)\}", lambda m: "{" + ", ".join(sorted(m.group(1).split(", ")))
                  + "}", text)


def test_str_matches_jax():
    hm, jhm = HookManager(keys=["train", "val"]), JHookManager(keys=["train", "val"])
    hm.register_shared(RecencyNeighborHook(4, [2], ["edge_src"], ["edge_time"], device="cpu"))
    jhm.register_shared(JRecency(4, [2], ["edge_src"], ["edge_time"]))
    hm.register("train", RandomNegativeEdgeSamplerHook(0, 4, device="cpu", id="x"))
    jhm.register("train", tgm_tpu.hooks.RandomNegativeEdgeSamplerHook(0, 4, id="x"))
    hm.set_active_hooks("val")
    jhm.set_active_hooks("val")
    text = str(hm)
    assert _sorted_sets(text) == _sorted_sets(str(jhm))
    assert "RandomNegativeEdgeSamplerHook_x" in text and "Active key: val" in text


@pytest.mark.parametrize("unit,bsize", [("r", 3), ("s", 10), ("s", 3)])
def test_num_valid_edges_matches_jax(unit, bsize):
    loader = DGDataLoader(tiny(DGData, DGraph, "s"), batch_size=bsize, batch_unit=unit,
                          pad_multiple=1, device="cpu")
    jloader = JDGDataLoader(tiny(JDGData, JDGraph, "s"), batch_size=bsize, batch_unit=unit,
                            pad_multiple=1)
    got = [b.num_valid_edges for b in loader]
    assert all(isinstance(n, torch.Tensor) and n.dim() == 0 for n in got)
    assert [int(n) for n in got] == [int(b.num_valid_edges) for b in jloader]
    batch = next(iter(loader))
    batch.edge_valid = None
    assert int(batch.num_valid_edges) == batch.edge_src.shape[0]


class _JHook(JStatelessHook):
    def __call__(self, dg, batch):
        return batch


def test_get_batch_attribute_reads_the_hook_suffix():
    for cls in (StatelessHook, _JHook):
        batch = DGDataLoader(tiny(DGData, DGraph), batch_size=3, device="cpu").__iter__()
        b = next(batch)
        plain, named = cls(), cls(id="a")
        plain.add_batch_attribute(b, "foo", 1)
        named.add_batch_attribute(b, "foo", 2)
        assert (plain.get_batch_attribute(b, "foo"), named.get_batch_attribute(b, "foo")) == (1, 2)
        assert b.foo_a == 2
        with pytest.raises(AttributeError):
            cls(id="b").get_batch_attribute(b, "foo")


# ---------------------------------------------------------------------- #
# Storage: get_nbrs and the backend registry
# ---------------------------------------------------------------------- #
NBR_CASES = {
    "undirected": (np.array([1]), 5, 6, False),
    "directed": (np.array([1]), 5, 20, True),
    "padded seed": (np.array([1, PADDED_NODE_ID, 3]), 4, 9, False),
    "no bound": (np.array([0, 2]), 8, None, False),
}


@pytest.mark.parametrize("case", list(NBR_CASES))
def test_get_nbrs_matches_jax(case):
    seeds, k, end, directed = NBR_CASES[case]
    dg, jdg = tiny(DGData, DGraph), tiny(JDGData, JDGraph)
    got = dg._storage.get_nbrs(seeds, num_nbrs=k, slice=type(dg._slice)(end_time=end),
                               directed=directed)
    want = jdg._storage.get_nbrs(seeds, num_nbrs=k, slice=type(jdg._slice)(end_time=end),
                                 directed=directed)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    if case == "undirected":  # node 1 before time 6: (0,1)@1, (1,2)@1, (1,3)@5
        np.testing.assert_array_equal(got[0][0], [0, 2, 3, PADDED_NODE_ID, PADDED_NODE_ID])
        np.testing.assert_array_equal(got[1][0, :3], [1, 1, 5])
        assert got[2].shape == (1, 5, 2)


def test_get_nbrs_subsamples_oversized_rows_like_jax():
    """Rows with more candidates than ``num_nbrs`` draw from an unseeded
    generator in both packages: each row is a sorted subset of its
    candidates, in (time, edge) order."""
    dg, jdg = tiny(DGData, DGraph), tiny(JDGData, JDGraph)
    seeds = np.array([1, 1, 2])
    full = dg._storage.get_nbrs(seeds, 8, type(dg._slice)(end_time=20), False)
    assert ((full[0] != PADDED_NODE_ID).sum(1) > 2).all()
    for store, sl in ((dg._storage, dg._slice), (jdg._storage, jdg._slice)):
        nids, times, feats = store.get_nbrs(seeds, num_nbrs=2, slice=type(sl)(end_time=20),
                                            directed=False)
        assert (nids != PADDED_NODE_ID).sum() == 6
        for r in range(len(seeds)):
            cand = list(zip(full[1][r], full[0][r], full[2][r, :, 0]))
            cand = [c for c, n in zip(cand, full[0][r]) if n != PADDED_NODE_ID]
            picked = list(zip(times[r], nids[r], feats[r, :, 0]))
            assert all(p in cand for p in picked)
            assert sorted(picked, key=cand.index) == picked


def test_storage_backend_registry():
    assert get_dg_storage_backend() is DGStorageArrayBackend
    assert DGStorageBackends == {"ArrayBackend": DGStorageArrayBackend}
    assert issubclass(DGStorageArrayBackend, DGStorageBase)
    set_dg_storage_backend("ArrayBackend")
    assert get_dg_storage_backend() is DGStorageArrayBackend
    assert isinstance(DGStorage(tiny(DGData, DGraph)._storage._data), DGStorageArrayBackend)
    with pytest.raises(ValueError):
        set_dg_storage_backend("NoSuchBackend")
    with pytest.raises(ValueError):
        set_dg_storage_backend(42)
    with pytest.raises(TypeError):
        DGStorageBase(None)  # abstract


def test_a_selected_backend_builds_every_graph(monkeypatch):
    class Counting(DGStorageArrayBackend):
        made = 0

        def __init__(self, data):
            super().__init__(data)
            Counting.made += 1

    from tgm_tpu_torch.core import _storage

    monkeypatch.setattr(_storage, "_current_backend", _storage._current_backend)
    set_dg_storage_backend(Counting)
    assert isinstance(tiny(DGData, DGraph)._storage, Counting) and Counting.made == 1


# ---------------------------------------------------------------------- #
# The analytics examples
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("script", ["batch_analytics_example", "dos", "node_analytics_example"])
def test_analytics_example_prints_what_jax_prints(monkeypatch, capsys, script):
    # Each ``dos`` module registers its hook class in its package's registry:
    # register into copies so that the registries stay as they were.
    from tgm_tpu.hooks import registry as jregistry
    from tgm_tpu_torch.hooks import registry

    for reg in (registry, jregistry):
        monkeypatch.setattr(reg, "_HOOK_REGISTRY", list(reg._HOOK_REGISTRY))
    port = importlib.import_module(f"tgm_tpu_torch.examples.analytics.{script}")
    out = port.main(["--device", "cpu"])
    got = capsys.readouterr().out
    monkeypatch.syspath_prepend(str(__import__("pathlib").Path(tgm_tpu.__file__).parents[1]))
    jmod = importlib.import_module(f"examples.analytics.{script}")
    monkeypatch.setattr(sys, "argv", ["prog"])
    jmod.main()
    want = capsys.readouterr().out
    assert got == want
    assert len(out) == (5 if script == "dos" else 10)
