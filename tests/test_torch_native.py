"""The port's C++ host sorts and searches (``tgm_tpu_torch.native``) against
numpy and the JAX package's ``tgm_tpu.native``, element for element, and the
data layer that calls them (an unsorted 70,000-event ingest and the temporal
CSR) bit-equal to the JAX package's.

g++ is on the machine that runs these tests, so the C++ path runs here; the
numpy paths run below the size thresholds, for negative keys and when the
library did not build.
"""

import numpy as np
import pytest

from tgm_tpu import DGData as JDGData
from tgm_tpu import native as jnative
from tgm_tpu_torch import DGData, native
from tgm_tpu_torch.core._storage import DGStorageArrayBackend
from tgm_tpu_torch.data import dg_data

EVENTS = 70_000


class _NoLibrary:
    """Stands in for the loaded library where the numpy path must run."""

    def __getattr__(self, name):
        raise AssertionError(f"the C++ {name} ran where the numpy path should")


def test_the_library_builds_from_the_port_source():
    assert native.native_available(), native.build_error
    assert native.build_error is None
    path = native._library_path()
    assert path.exists() and path.parent.parent == native.BUILD_ROOT
    assert path.parent.parent.name == "_build" and path.parent.parent.parent.name == "tgm_tpu_torch"


@pytest.mark.parametrize("high", [1_000, 2**62], ids=["ties", "wide"])
def test_stable_sort_perm_is_exact(high):
    keys = np.random.default_rng(0).integers(0, high, EVENTS)
    got = native.stable_sort_perm(keys)
    np.testing.assert_array_equal(got, np.argsort(keys, kind="stable"))
    np.testing.assert_array_equal(got, jnative.stable_sort_perm(keys))


@pytest.mark.parametrize("high", [(500, 500), (20_000, 2**40)], ids=["ties", "wide"])
def test_lexsort2_perm_is_exact(high):
    rng = np.random.default_rng(1)
    primary, secondary = rng.integers(0, high[0], EVENTS), rng.integers(0, high[1], EVENTS)
    got = native.lexsort2_perm(primary, secondary)
    np.testing.assert_array_equal(got, np.lexsort((secondary, primary)))
    np.testing.assert_array_equal(got, jnative.lexsort2_perm(primary, secondary))


@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted_is_exact(side):
    rng = np.random.default_rng(2)
    arr = np.sort(rng.integers(0, 10_000, 50_000))
    q = rng.integers(-10, 10_010, 5_000)
    got = native.searchsorted(arr, q, side=side)
    np.testing.assert_array_equal(got, np.searchsorted(arr, q, side=side))
    np.testing.assert_array_equal(got, jnative.searchsorted(arr, q, side=side))


def test_small_and_negative_inputs_take_the_numpy_paths(monkeypatch):
    native.native_available()
    monkeypatch.setattr(native, "_lib", _NoLibrary())
    rng = np.random.default_rng(3)
    small = rng.integers(0, 50, native._MIN_NATIVE_N - 1)
    np.testing.assert_array_equal(native.stable_sort_perm(small),
                                  np.argsort(small, kind="stable"))
    np.testing.assert_array_equal(native.lexsort2_perm(small, small[::-1]),
                                  np.lexsort((small[::-1], small)))
    neg = rng.integers(-100, 100, EVENTS)
    np.testing.assert_array_equal(native.stable_sort_perm(neg), np.argsort(neg, kind="stable"))
    big = rng.integers(0, 100, EVENTS)
    np.testing.assert_array_equal(native.lexsort2_perm(big, neg), np.lexsort((neg, big)))
    np.testing.assert_array_equal(native.lexsort2_perm(neg, big), np.lexsort((big, neg)))
    arr = np.sort(big)
    q = rng.integers(0, 100, native._MIN_NATIVE_QUERIES - 1)
    np.testing.assert_array_equal(native.searchsorted(arr, q, "right"),
                                  np.searchsorted(arr, q, "right"))
    np.testing.assert_array_equal(native.stable_sort_perm(np.zeros(0, np.int64)), [])


def test_a_failed_build_falls_back_to_numpy(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", True)
    assert not native.native_available()
    keys = np.random.default_rng(4).integers(0, 1_000, EVENTS)
    np.testing.assert_array_equal(native.stable_sort_perm(keys), np.argsort(keys, kind="stable"))
    np.testing.assert_array_equal(native.lexsort2_perm(keys, keys), np.lexsort((keys, keys)))
    arr = np.sort(keys)
    np.testing.assert_array_equal(native.searchsorted(arr, keys), np.searchsorted(arr, keys))


def test_bad_arguments_raise():
    with pytest.raises(ValueError, match="side"):
        native.searchsorted(np.arange(4), np.arange(2), side="middle")
    with pytest.raises(ValueError, match="primary"):
        native.lexsort2_perm(np.arange(4), np.arange(3))


def unsorted_events(seed=5):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 20_000, EVENTS)  # many ties: the sort's stability shows
    edges = rng.integers(0, 3_000, (EVENTS, 2))
    edge_x = rng.normal(size=(EVENTS, 4)).astype(np.float32)
    return t, edges, edge_x


def test_unsorted_ingest_and_temporal_csr_are_bit_equal_to_jax(monkeypatch):
    calls = {"sort": 0, "lexsort": 0}

    def counted(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(dg_data, "stable_sort_perm",
                        counted("sort", dg_data.stable_sort_perm))
    from tgm_tpu_torch.core._storage import array_backend
    monkeypatch.setattr(array_backend, "lexsort2_perm",
                        counted("lexsort", array_backend.lexsort2_perm))
    t, edges, edge_x = unsorted_events()
    data = DGData.from_raw(t, edges, edge_x, time_delta="s")
    jdata = JDGData.from_raw(t, edges, edge_x, time_delta="s")
    assert calls["sort"] == 1
    for name in ("time", "edge_mask", "edge_index", "edge_x"):
        np.testing.assert_array_equal(getattr(data, name), np.asarray(getattr(jdata, name)),
                                      err_msg=name)
    store = DGStorageArrayBackend(data)
    from tgm_tpu.core._storage.array_backend import DGStorageArrayBackend as JBackend

    jstore = JBackend(jdata)
    for directed in (False, True):
        got, want = store.temporal_csr(directed), jstore.temporal_csr(directed)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, b)
    assert calls["lexsort"] == 2
