"""In-place int32 state scatters: kernels K2 and K3 and their plain versions.

Port of ``tgm_tpu/ops/pallas/scatter_cells.py``. Where the JAX functions
return a new array, these write into the tensor they are given and return it:
the callers' state tensors are updated in place.

On CUDA tensors the wrappers launch the hand-written kernels in
``csrc/scatter_cells.cu``; on CPU tensors they run the plain versions. Both
skip targets past the last live row and leave every skipped row as it was.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _native


def _require_int32(device: torch.device, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")


def _put_live(x: torch.Tensor, index: Tuple[torch.Tensor, ...], live: torch.Tensor,
              vals: torch.Tensor) -> None:
    """``x[index] = vals`` where ``live``; other writes go to the last row,
    which is restored afterwards (the JAX path's write-then-reset)."""
    last = x.shape[0] - 1
    saved = x[last].clone()
    idx = (torch.where(live, index[0], last).long(),) + tuple(
        torch.where(live, i, 0).long() for i in index[1:]
    )
    x.index_put_(idx, vals)
    x[last] = saved


def scatter_cells_plain(buf: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                        vals: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: masked ``index_put_`` plus a dump-row restore."""
    N1, B = buf.shape
    live = (rows >= 0) & (rows <= N1 - 2) & (cols >= 0) & (cols < B)
    _put_live(buf, (rows, cols), live, vals)
    return buf


def scatter_cells(buf: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """``buf[rows[i], cols[i]] = vals[i]`` in place on an (N1, B) int32 buffer.

    Targets with rows > N1 - 2 (the dump row and beyond) are skipped. Each
    live target must be written at most once (the recency push plan
    guarantees it). Kernel K2 on CUDA tensors; ``scatter_cells.launches``
    counts its launches.
    """
    if buf.dim() != 2:
        raise ValueError(f"buf must be 2-D, got shape {tuple(buf.shape)}")
    E = rows.shape[0]
    if rows.shape != (E,) or cols.shape != (E,) or vals.shape != (E,):
        raise ValueError("rows, cols and vals must be 1-D of one length")
    _require_int32(buf.device, buf=buf, rows=rows, cols=cols, vals=vals)
    if buf.device.type == "cpu":
        return scatter_cells_plain(buf, rows, cols, vals)
    if buf.device.type != "cuda":
        raise ValueError(f"unsupported device {buf.device}")
    if not buf.is_contiguous():
        raise ValueError("buf must be contiguous: the kernel writes it in place")
    if E == 0:
        return buf
    N1, B = buf.shape
    rows, cols, vals = (t.contiguous() for t in (rows, cols, vals))
    _native.launch("scatter_cells", "scatter_cells", [buf, rows, cols, vals], [E, N1, B])
    scatter_cells.launches += 1
    return buf


scatter_cells.launches = 0


def tgn_store_scatter_1d_plain(s_other, s_t, d_other, d_t, rows_s, vals_s_other, vals_s_t,
                               rows_d, vals_d_other, vals_d_t, last_live_row: int):
    """Plain version of K3: four masked ``index_put_`` calls."""
    live_s = (rows_s >= 0) & (rows_s <= last_live_row)
    live_d = (rows_d >= 0) & (rows_d <= last_live_row)
    _put_live(s_other, (rows_s,), live_s, vals_s_other)
    _put_live(s_t, (rows_s,), live_s, vals_s_t)
    _put_live(d_other, (rows_d,), live_d, vals_d_other)
    _put_live(d_t, (rows_d,), live_d, vals_d_t)
    return s_other, s_t, d_other, d_t


def tgn_store_scatter_1d(s_other, s_t, d_other, d_t, rows_s, vals_s_other, vals_s_t,
                         rows_d, vals_d_other, vals_d_t, last_live_row: int):
    """In place: ``s_other/s_t[rows_s] = vals`` and ``d_other/d_t[rows_d] = vals``.

    Rows past ``last_live_row`` (the dump row and beyond) are skipped; each
    live row is written at most once per role. One launch of kernel K3 does
    all four stores on CUDA tensors; ``tgn_store_scatter_1d.launches`` counts
    its launches. Unlike the TPU kernel it needs no 128-row padding.
    """
    stores = dict(s_other=s_other, s_t=s_t, d_other=d_other, d_t=d_t)
    N1 = s_other.shape[0]
    for name, t in stores.items():
        if t.shape != (N1,):
            raise ValueError(f"{name} must have shape {(N1,)}, got {tuple(t.shape)}")
    E = rows_s.shape[0]
    updates = dict(rows_s=rows_s, vals_s_other=vals_s_other, vals_s_t=vals_s_t,
                   rows_d=rows_d, vals_d_other=vals_d_other, vals_d_t=vals_d_t)
    for name, t in updates.items():
        if t.shape != (E,):
            raise ValueError(f"{name} must have shape {(E,)}, got {tuple(t.shape)}")
    if not 0 <= last_live_row < N1 - 1:
        raise ValueError(f"last_live_row must be in [0, {N1 - 1}), got {last_live_row}")
    _require_int32(s_other.device, **stores, **updates)
    args = (s_other, s_t, d_other, d_t, rows_s, vals_s_other, vals_s_t,
            rows_d, vals_d_other, vals_d_t)
    if s_other.device.type == "cpu":
        return tgn_store_scatter_1d_plain(*args, last_live_row)
    if s_other.device.type != "cuda":
        raise ValueError(f"unsupported device {s_other.device}")
    if not all(t.is_contiguous() for t in stores.values()):
        raise ValueError("the stores must be contiguous: the kernel writes them in place")
    if E == 0:
        return s_other, s_t, d_other, d_t
    ins = [t.contiguous() for t in updates.values()]
    _native.launch("scatter_cells", "tgn_store_scatter_1d", [*stores.values(), *ins],
                   [E, last_live_row])
    tgn_store_scatter_1d.launches += 1
    return s_other, s_t, d_other, d_t


tgn_store_scatter_1d.launches = 0
