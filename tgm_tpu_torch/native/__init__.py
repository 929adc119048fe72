"""C++ host sorts and searches (port of ``tgm_tpu/native``).

The card owns the model compute; this package speeds up the host data path
around it: the event-timeline sort and the temporal CSR's (node, time) sort
that dominate large-graph ingest, and a batched binary search. The port's
own copy of ``fast_host_ops.cpp`` is compiled at first use with ``g++``
(OpenMP, ``-march=native``) into ``tgm_tpu_torch/_build/`` under a
directory named by a hash of the source, the flags and the target the
compiler resolves ``-march=native`` to, so an edited source or another CPU
gets its own build; the library is loaded with ``ctypes``. Nothing here
runs at import time.

Each entry point's permutation or index array equals numpy's element for
element. Below ``_MIN_NATIVE_N`` keys (1,024 queries for ``searchsorted``),
for negative keys, and where the library does not build, the numpy path
runs; ``native_available()`` says whether the library loaded and
``build_error`` why it did not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().with_name("fast_host_ops.cpp")
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-fopenmp")
_LIB_NAME = "libtgm_fast_host_ops.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False
# Why the library did not load (None while it loads, or before the first try).
build_error: Optional[str] = None

# Below this size the numpy paths win on call overhead.
_MIN_NATIVE_N = 1 << 16
_MIN_NATIVE_QUERIES = 1024

_I64P = ctypes.POINTER(ctypes.c_int64)


def _library_path() -> Path:
    """Where the build for this source, these flags and this CPU lives."""
    # The macros g++ predefines under -march=native name the instruction
    # sets the build may use: a library built on another CPU gets another key.
    target = subprocess.run(["g++", "-march=native", "-dM", "-E", "-x", "c++", "-"], input="",
                            capture_output=True, text=True, check=True, timeout=60).stdout
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    h.update("\n".join(sorted(target.splitlines())).encode())
    return BUILD_ROOT / f"native-{h.hexdigest()[:16]}" / _LIB_NAME


def _build() -> Path:
    path = _library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(_SRC), "-o", tmp], check=True,
                       capture_output=True, text=True, timeout=300)
        # Atomic rename: a concurrent process never loads a half-written file.
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed, build_error
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(_build()))
        except subprocess.CalledProcessError as e:
            _load_failed, build_error = True, f"{' '.join(e.cmd)}: {e.stderr}"
            return None
        except (OSError, subprocess.SubprocessError) as e:
            _load_failed, build_error = True, f"{type(e).__name__}: {e}"
            return None
        lib.stable_sort_perm_i64.argtypes = [_I64P, ctypes.c_int64, _I64P]
        lib.stable_sort_perm_i64.restype = ctypes.c_int
        lib.lexsort2_perm_i64.argtypes = [_I64P, _I64P, ctypes.c_int64, _I64P]
        lib.lexsort2_perm_i64.restype = ctypes.c_int
        lib.searchsorted_i64.argtypes = [_I64P, ctypes.c_int64, _I64P, ctypes.c_int64,
                                         ctypes.c_int, _I64P]
        lib.searchsorted_i64.restype = None
        _lib = lib
    return _lib


def native_available() -> bool:
    """Whether the C++ library built and loaded (it builds at the first call)."""
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_I64P)


def stable_sort_perm(keys: np.ndarray) -> np.ndarray:
    """Stable argsort of integer keys, ``np.argsort(keys, kind="stable")``
    (a parallel radix sort for non-negative keys)."""
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    lib = _load()
    if lib is None or len(keys) < _MIN_NATIVE_N or keys.min() < 0:
        return np.argsort(keys, kind="stable")
    perm = np.empty(len(keys), dtype=np.int64)
    if lib.stable_sort_perm_i64(_ptr(keys), len(keys), _ptr(perm)) != 0:
        return np.argsort(keys, kind="stable")
    return perm


def lexsort2_perm(primary: np.ndarray, secondary: np.ndarray) -> np.ndarray:
    """Stable argsort by ``(primary, secondary)``, ``np.lexsort((secondary, primary))``."""
    primary = np.ascontiguousarray(primary, dtype=np.int64)
    secondary = np.ascontiguousarray(secondary, dtype=np.int64)
    if len(primary) != len(secondary):
        raise ValueError(f"lexsort2_perm: {len(primary)} primary and {len(secondary)} "
                         "secondary keys")
    lib = _load()
    if (lib is None or len(primary) < _MIN_NATIVE_N or primary.min() < 0
            or secondary.min() < 0):
        return np.lexsort((secondary, primary))
    perm = np.empty(len(primary), dtype=np.int64)
    if lib.lexsort2_perm_i64(_ptr(primary), _ptr(secondary), len(primary), _ptr(perm)) != 0:
        return np.lexsort((secondary, primary))
    return perm


def searchsorted(sorted_arr: np.ndarray, queries: np.ndarray, side: str = "left") -> np.ndarray:
    """``np.searchsorted(sorted_arr, queries, side)`` over int64 (a parallel
    binary search per query)."""
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    sorted_arr = np.ascontiguousarray(sorted_arr, dtype=np.int64)
    queries = np.ascontiguousarray(queries, dtype=np.int64)
    lib = _load()
    if lib is None or queries.ndim != 1 or len(queries) < _MIN_NATIVE_QUERIES:
        return np.searchsorted(sorted_arr, queries, side=side)
    out = np.empty(len(queries), dtype=np.int64)
    lib.searchsorted_i64(_ptr(sorted_arr), len(sorted_arr), _ptr(queries), len(queries),
                         0 if side == "left" else 1, _ptr(out))
    return out


__all__ = ["lexsort2_perm", "native_available", "searchsorted", "stable_sort_perm"]
