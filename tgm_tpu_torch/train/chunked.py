"""Chunk-streamed epochs for streams larger than device memory (port of
``tgm_tpu/train/chunked.py``).

``DeviceEdgeStream`` uploads a whole split once, which fits tgbl-wiki (about
108 MB of edge features) but not the large tier (tgbl-flight, about 67M
edges, tens of GB of features). ``ChunkedEdgeStream`` keeps the split on the
host and serves it to the device a chunk of ``chunk_batches`` batches at a
time, with the batch plan of ``DeviceEdgeStream``: a chunked epoch runs the
same batches as a resident one, so the two give the same results.

On a card the upload overlaps the compute:

* the stream holds two pinned host staging buffers of one chunk each; the
  host copies a chunk's numpy slices into one (padding the last chunk), and
  a ``torch.cuda.Stream`` of the stream's own issues a non-blocking
  host-to-device copy from it. A staging buffer is refilled only after the
  event recorded behind its last copy has passed;
* a chunk's device tensors are allocated on that copy stream; before it
  touches them, the compute stream waits on the upload's event and the
  tensors are recorded on it (``record_stream``), so the allocator reuses
  their memory only after the compute stream's work on them is done;
* ``chunked_hook_epoch`` uploads chunk k + 1 while chunk k computes, and the
  next epoch's chunk 0 while the last chunk computes; after each chunk it
  copies the chunk's step outputs to the host, which waits for the chunk's
  compute, so at most two chunks are live on the device.

The host tables are never pinned or copied whole: a caller's float32
feature table is kept by reference, the padding of the last batch is
written into the staging buffer, and only ``feat_dtype=torch.bfloat16``
converts the table, once, into a bf16 CPU tensor (half the bytes in
transit; ``batch_at`` casts back to float32 on the device). With
``device="cpu"`` chunks are host tensors sliced from the tables, with no
streams and no pinning.

Streams larger than device memory rule out the recency hook's eid layout,
which gathers features from a device-resident ``edge_x`` table; use the
feature layout (``edge_x_full=None``), whose buffers hold the K most recent
edges' features by value and scale with the node count.
"""

from __future__ import annotations

import math
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..constants import PADDED_NODE_ID
from ..core.batch import DGBatch
from ..core.graph import DGraph
from ..device import DeviceLike, resolve_device
from .epoch import stack_outs

Chunk = Dict[str, Any]


class ChunkedEdgeStream:
    """A split's edge events on the host, served to ``device`` chunk by chunk.

    ``batch_at(put_chunk(k), i)`` is batch ``k * chunk_batches + i`` of
    ``DeviceEdgeStream(dg, batch_size)``: src, dst, t and valid, global
    ``edge_ids`` and (with ``include_features``) ``edge_x``.
    """

    def __init__(
        self,
        dg: DGraph,
        batch_size: int,
        chunk_batches: int,
        include_features: bool = True,
        edge_id_base: Optional[int] = None,
        feat_dtype: Optional[torch.dtype] = None,
        device: DeviceLike = None,
    ):
        if edge_id_base is None:
            edge_id_base = int(getattr(dg._storage._data, "edge_global_offset", 0))
        src, dst, t = dg._storage.get_edges(dg._slice)
        edge_x = dg._storage.get_edge_x(dg._slice) if include_features else None
        self._init_from_arrays(src, dst, t, edge_x, batch_size, chunk_batches, edge_id_base,
                               feat_dtype, device)

    @classmethod
    def from_arrays(
        cls,
        src: np.ndarray,
        dst: np.ndarray,
        t: np.ndarray,
        edge_x: Optional[np.ndarray],
        batch_size: int,
        chunk_batches: int,
        edge_id_base: int = 0,
        feat_dtype: Optional[torch.dtype] = None,
        device: DeviceLike = None,
    ) -> "ChunkedEdgeStream":
        self = cls.__new__(cls)
        self._init_from_arrays(src, dst, t, edge_x, batch_size, chunk_batches, edge_id_base,
                               feat_dtype, device)
        return self

    def _init_from_arrays(self, src, dst, t, edge_x, batch_size, chunk_batches, edge_id_base,
                          feat_dtype, device):
        if chunk_batches < 1:
            raise ValueError(f"chunk_batches must be >= 1, got {chunk_batches}")
        if feat_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"feat_dtype must be None, torch.float32 or torch.bfloat16, "
                             f"got {feat_dtype!r}")
        self.device = resolve_device(device)
        E = len(src)
        self.num_edges = E
        self.batch_size = B = batch_size
        self.num_batches = max(1, math.ceil(E / B))
        self.chunk_batches = min(chunk_batches, self.num_batches)
        self.num_chunks = math.ceil(self.num_batches / self.chunk_batches)
        self._edge_id_base = edge_id_base

        # By reference where the caller's arrays are already contiguous int32.
        self._src = np.ascontiguousarray(src, np.int32)
        self._dst = np.ascontiguousarray(dst, np.int32)
        self._t = np.ascontiguousarray(t, np.int32)
        self._edge_x: Optional[torch.Tensor] = None
        self.edge_dim = 0
        if edge_x is not None:
            self.edge_dim = edge_x.shape[1]
            x = torch.from_numpy(np.ascontiguousarray(edge_x, np.float32))
            self._edge_x = x if feat_dtype in (None, torch.float32) else x.to(feat_dtype)

        counts = np.full(self.num_batches, B, np.int32)
        counts[-1] = E - (self.num_batches - 1) * B
        self._counts = counts
        self._ar = torch.arange(B, dtype=torch.int32, device=self.device)
        # Card only, made at the first upload: the copy stream and the two
        # staging buffers with the events behind their last copies.
        self._copy_stream: Optional[torch.cuda.Stream] = None
        self._staging: List[Dict[str, Any]] = []
        self._next_slot = 0

    # ------------------------------------------------------------------ #
    # Chunk upload
    # ------------------------------------------------------------------ #
    def _chunk_len(self, k: int) -> int:
        c0 = k * self.chunk_batches
        return min(self.chunk_batches, self.num_batches - c0)

    @property
    def chunk_nbytes(self) -> int:
        """Device bytes of one full chunk (the device working-set unit)."""
        B, C = self.batch_size, self.chunk_batches
        per_edge = 3 * 4  # src, dst, t int32
        if self._edge_x is not None:
            per_edge += self.edge_dim * self._edge_x.element_size()
        return C * B * per_edge + C * 4 + 4

    def _fill(self, k: int, out: Dict[str, torch.Tensor]) -> int:
        """Write chunk ``k``'s rows (padded past the last edge) and its
        ``meta`` (the batches' counts, then the chunk's first edge id) into
        the host tensors ``out``; returns the chunk's row count."""
        B, c0, ck = self.batch_size, k * self.chunk_batches, self._chunk_len(k)
        lo, n = c0 * B, ck * B
        m = min(n, self.num_edges - lo)
        for name, fill in (("src", PADDED_NODE_ID), ("dst", PADDED_NODE_ID), ("t", 0)):
            dst = out[name].numpy()
            dst[:m] = getattr(self, f"_{name}")[lo:lo + m]
            dst[m:n] = fill
        meta = out["meta"].numpy()
        meta[:ck] = self._counts[c0:c0 + ck]
        meta[ck] = self._edge_id_base + lo
        if self._edge_x is not None:
            out["x"][:m].copy_(self._edge_x[lo:lo + m])
            out["x"][m:n].zero_()
        return n

    def _host_tensors(self, rows: int, batches: int, pin: bool) -> Dict[str, torch.Tensor]:
        out = {name: torch.empty(rows, dtype=torch.int32, pin_memory=pin)
               for name in ("src", "dst", "t")}
        out["meta"] = torch.empty(batches + 1, dtype=torch.int32, pin_memory=pin)
        if self._edge_x is not None:
            out["x"] = torch.empty(rows, self.edge_dim, dtype=self._edge_x.dtype,
                                   pin_memory=pin)
        return out

    def put_chunk(self, k: int) -> Chunk:
        """Chunk ``k``'s arrays on the stream's device.

        On a card the copy is issued on the stream's copy stream and this
        returns without waiting for it; the first ``batch_at`` of the chunk
        makes the current stream wait for it.
        """
        if not 0 <= k < self.num_chunks:
            raise IndexError(f"chunk {k} out of range [0, {self.num_chunks})")
        ck = self._chunk_len(k)
        if self.device.type != "cuda":
            host = self._host_tensors(ck * self.batch_size, ck, pin=False)
            self._fill(k, host)
            return host
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
            rows = self.chunk_batches * self.batch_size
            self._staging = [{"host": self._host_tensors(rows, self.chunk_batches, pin=True),
                              "done": None} for _ in range(2)]
        slot = self._staging[self._next_slot]
        self._next_slot ^= 1
        if slot["done"] is not None:
            slot["done"].synchronize()  # the previous copy from this buffer has landed
        n = self._fill(k, slot["host"])
        chunk: Chunk = {}
        with torch.cuda.stream(self._copy_stream):
            for name, h in slot["host"].items():
                h = h[: ck + 1] if name == "meta" else h[:n]
                chunk[name] = torch.empty_like(h, device=self.device).copy_(h, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        slot["done"] = chunk["uploaded"] = done
        return chunk

    # ------------------------------------------------------------------ #
    # Batch windows
    # ------------------------------------------------------------------ #
    def batch_at(self, chunk: Chunk, i: int) -> DGBatch:
        """Chunk-local batch ``i`` of ``chunk`` (views of its rows; padded
        rows hold PAD / 0 / -1 and zero features)."""
        done = chunk.pop("uploaded", None)
        if done is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(done)
            for t in chunk.values():
                t.record_stream(compute)
        B = self.batch_size
        meta = chunk["meta"]
        if not 0 <= i < meta.shape[0] - 1:
            raise IndexError(f"batch {i} out of range [0, {meta.shape[0] - 1})")
        sl = slice(i * B, (i + 1) * B)
        valid = self._ar < meta[i]
        batch = DGBatch(chunk["src"][sl], chunk["dst"][sl], chunk["t"][sl], valid,
                        edge_ids=torch.where(valid, self._ar + (meta[-1] + i * B), -1))
        if "x" in chunk:
            batch.edge_x = chunk["x"][sl].float()
        return batch


def _to_host(out: Any) -> Any:
    if isinstance(out, tuple):
        return tuple(o.cpu() for o in out)
    return out.cpu()


def _concat(outs: List[Any]) -> Any:
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(list(col)) for col in zip(*outs))
    return torch.cat(outs)


def chunked_hook_epoch(
    stream: ChunkedEdgeStream,
    hm: Any,
    key: str,
    dg: DGraph,
    step_fn: Callable[[Any, Any], Tuple[Any, Any]],
    donate: bool = True,
):
    """One chunk-streamed epoch over ``stream`` with ``key``'s hook pipeline.

    The contract of ``scanned_hook_epoch``: returns ``(epoch_fn,
    init_hook_states)`` with ``epoch_fn(carry, hook_states) -> (carry,
    hook_states, outs)``. ``outs`` stacks each batch's output (tensors, or
    tuples of them) and comes back on the host: each chunk's outputs are
    copied there once the chunk has run, which is the epoch's one wait for
    the card a chunk. ``donate`` is accepted for the JAX signature and has
    no effect.

    Chunk k + 1 uploads while chunk k computes, and the next epoch's chunk 0
    while the last chunk computes. ``epoch_fn.close()`` waits for that
    prefetched upload and drops it; it can be called more than once, and
    runs when ``epoch_fn`` is garbage-collected.
    """
    hook_fn, init_states = hm.as_transform(key, dg)
    pending: List[Chunk] = []

    def close() -> None:
        while pending:
            done = pending.pop().get("uploaded")
            if done is not None:
                done.synchronize()  # let an upload in flight land before its buffers go

    def run_chunk(carry, hook_states, chunk: Chunk, n: int):
        outs = []
        for i in range(n):
            hook_states, batch = hook_fn(hook_states, stream.batch_at(chunk, i))
            carry, out = step_fn(carry, batch)
            outs.append(out)
        # The copy to the host waits for the chunk's compute, so the chunk's
        # memory is free once the caller drops it.
        return carry, hook_states, _to_host(stack_outs(outs))

    def epoch(carry, hook_states):
        outs = []
        chunk = pending.pop() if pending else stream.put_chunk(0)
        for k in range(stream.num_chunks):
            if k + 1 < stream.num_chunks:
                nxt = stream.put_chunk(k + 1)
            else:
                # The next epoch's first chunk uploads under the last one.
                pending.append(stream.put_chunk(0))
                nxt = None
            carry, hook_states, o = run_chunk(carry, hook_states, chunk,
                                              stream._chunk_len(k))
            outs.append(o)
            chunk = nxt
        return carry, hook_states, _concat(outs)

    epoch.close = close
    weakref.finalize(epoch, close)
    return epoch, init_states


__all__ = ["ChunkedEdgeStream", "chunked_hook_epoch"]
