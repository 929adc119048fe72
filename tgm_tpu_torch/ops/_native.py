"""Build and load the CUDA kernels of ``tgm_tpu_torch/csrc``.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``. The build runs at
first use, from the sources in the package and nothing else: all sources are
compiled together, one ``nvcc`` process each, into ``tgm_tpu_torch/_build/``
under a directory named by a hash of the sources and flags, so an edited
source is rebuilt. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

# Shared memory one block of an H100 can use (opt-in, dynamic).
MAX_SHARED_BYTES = 232_448

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}
# How long the last build's nvcc runs took.
build_seconds: float = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every source that has no library yet, all ``nvcc`` runs at once."""
    global build_seconds
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [s for s in _sources() if not (out_dir / f"lib{s.stem}.so").exists()]
    if not todo:
        return out_dir
    t0 = time.perf_counter()
    nvcc = _nvcc()
    procs = []
    for src in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
            os.unlink(tmp)
        else:
            # Atomic rename: a concurrent process never loads a half-written file.
            os.replace(tmp, out_dir / f"lib{src.stem}.so")
    build_seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out_dir


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built at first use)."""
    if name not in _libs:
        path = build_all() / f"lib{name}.so"
        _libs[name] = ctypes.CDLL(str(path))
    return _libs[name]


def launch(lib: str, name: str, tensors: Sequence[torch.Tensor], ints: Sequence[int]) -> None:
    """Call the C launcher ``name`` of ``csrc/<lib>.cu`` on the tensors' device.

    Every launcher takes the tensors' pointers, then ``int`` sizes, then the
    CUDA stream (PyTorch's current one), and returns ``cudaGetLastError()``;
    a non-zero error raises.
    """
    key = (lib, name)
    if key not in _fns:
        fn = getattr(load(lib), name)
        fn.argtypes = ([ctypes.c_void_p] * len(tensors) + [ctypes.c_int] * len(ints)
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[key] = fn
    with torch.cuda.device(tensors[0].device):
        err = _fns[key](*(t.data_ptr() for t in tensors), *ints,
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
