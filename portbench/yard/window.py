"""The measured window: the eval splits served batch after batch through
``tgm_tpu_torch.train.hook_epoch``, closed loop, from a snapshot of the
state, again and again until the time is up.

The benchmark's own wrappers sit around the calls into each layer: the
stream's ``batch_at`` (span ``stream``), the key's hook DAG (span
``hooks``) and the model's eval core (span ``step``); a CUDA event is
recorded after each batch. For the sampled batches the window copies the
hook products and what the program's ``captures`` name into buffers made
before it. The window closes at the end of the batch in which the time
runs out.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

import torch
from torch.profiler import record_function

from tgm_tpu_torch.train import hook_epoch

PRODUCTS = ("seed_nids", "seed_times", "nbr_nids", "nbr_edge_time", "nbr_edge_x")


class WindowClosed(Exception):
    """Raised by the step wrapper after the batch in which time ran out."""


@dataclass
class BatchRec:
    split: str
    index: int
    n_edges: int
    out: Tuple[torch.Tensor, torch.Tensor]
    event: Optional[torch.cuda.Event]
    t_fetch: float  # host clock when batch_at was called
    t_step: float  # host clock when the eval core was called
    t_done: float  # host clock when it returned


@dataclass
class Capture:
    """A tensor the window keeps for the sampled batches: the input
    (``what="in"``) or the output of ``module``, its first ``rows`` rows
    (all of them for None). A module called several times a batch gives
    one tensor a call, named ``<name>.<call>``."""

    name: str
    module: torch.nn.Module
    what: str = "out"
    rows: Optional[int] = None


@dataclass
class Recorder:
    device: torch.device
    trace: bool
    samples: Set[Tuple[str, int]] = field(default_factory=set)
    keep_rows: int = 0
    limit_batches: Optional[int] = None
    deadline: float = float("inf")
    recs: List[BatchRec] = field(default_factory=list)
    pass_starts: List[Tuple[int, Optional[torch.cuda.Event]]] = field(default_factory=list)
    captures: Dict[Tuple[str, int], Dict[str, torch.Tensor]] = field(default_factory=dict)
    # With ``probe``, the shapes of what a sampled batch keeps; ``allocate``
    # makes its buffers before the window, so that the peak holds them
    # whichever batches the window reaches.
    probe: bool = False
    shapes: Dict[str, Tuple[torch.Size, torch.dtype]] = field(default_factory=dict)
    bufs: Dict[Tuple[str, int], Dict[str, torch.Tensor]] = field(default_factory=dict)
    split: str = ""
    index: int = 0
    t_fetch: float = 0.0
    armed: Optional[Tuple[str, int]] = None
    calls: Dict[str, int] = field(default_factory=dict)

    def span(self, name: str):
        return record_function(name) if self.trace else contextlib.nullcontext()

    def event(self) -> Optional[torch.cuda.Event]:
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def allocate(self, shapes) -> None:
        for key in self.samples:
            self.bufs[key] = {n: torch.empty(sh, dtype=dt, device=self.device)
                              for n, (sh, dt) in shapes.items()}

    def keep(self, name: str, t: torch.Tensor) -> None:
        if self.probe:
            self.shapes[name] = (t.shape, t.dtype)
        if self.armed is not None:
            self.captures[self.armed][name] = self.bufs[self.armed][name].copy_(t)

    def hook(self, cap: Capture):
        def on_forward(module, inputs, output) -> None:
            if not (self.probe or self.armed is not None):
                return
            t = inputs[0] if cap.what == "in" else output
            i = self.calls.get(cap.name, 0)
            self.calls[cap.name] = i + 1
            self.keep(f"{cap.name}.{i}", t if cap.rows is None else t[:cap.rows])

        return on_forward

    @contextlib.contextmanager
    def hooked(self, captures: List[Capture]):
        handles = [c.module.register_forward_hook(self.hook(c)) for c in captures]
        try:
            yield self
        finally:
            for h in handles:
                h.remove()


class SpanStream:
    """A ``DeviceEdgeStream`` whose ``batch_at`` is timed and spanned."""

    def __init__(self, stream, rec: Recorder) -> None:
        self._s, self._rec = stream, rec
        self.num_batches = stream.num_batches

    def batch_at(self, i: int):
        self._rec.t_fetch = time.perf_counter()
        self._rec.index = i
        with self._rec.span("stream"):
            return self._s.batch_at(i)


class SpanHooks:
    """A ``HookManager`` whose transform runs inside the span ``hooks``."""

    def __init__(self, hm, rec: Recorder) -> None:
        self._hm, self._rec = hm, rec

    def as_transform(self, key, dg):
        fn, states = self._hm.as_transform(key, dg)

        def spanned(st, batch):
            with self._rec.span("hooks"):
                return fn(st, batch)

        return spanned, states


def wrap_step(core: Callable, rec: Recorder, n_edges_of: Callable[[str, int], int]) -> Callable:
    """The eval core inside the span ``step``, with the batch's CUDA event,
    host times and, for sampled batches, copies of the hook products and
    of what the program's captures name."""

    def step(carry, batch):
        t_step = time.perf_counter()
        key = (rec.split, rec.index)
        r = rec.keep_rows
        rec.calls = {}
        if key in rec.bufs and key not in rec.captures:
            rec.armed = key
            rec.captures[key] = {}
        if rec.probe or rec.armed is not None:
            for n in PRODUCTS:
                rec.keep("product." + n, getattr(batch, n)[0][:r])
        with rec.span("step"):
            carry, out = core(carry, batch)
        rec.armed = None
        rec.recs.append(BatchRec(rec.split, rec.index, n_edges_of(rec.split, rec.index), out,
                                 rec.event(), rec.t_fetch, t_step, time.perf_counter()))
        done = rec.recs[-1].t_done >= rec.deadline or (
            rec.limit_batches is not None and len(rec.recs) >= rec.limit_batches)
        if done:
            raise WindowClosed
        return carry, out

    return step


def serve(prog, rec: Recorder, passes) -> None:
    """Restore the snapshot and serve the splits ``passes`` in turn, again
    and again, until the recorder closes the window."""
    setup = prog.setup
    stream_of = {k: SpanStream(setup.streams[k], rec) for k in passes}
    hooks = SpanHooks(setup.hm, rec)
    B = setup.streams["val"].batch_size
    n_edges_of = lambda split, i: min(B, setup.streams[split].num_edges - i * B)
    step = wrap_step(prog.core, rec, n_edges_of)
    while True:
        with rec.span("restore"):
            prog.restore()
        rec.pass_starts.append((len(rec.recs), rec.event()))
        carry = prog.carry
        try:
            for split in passes:
                rec.split = split
                epoch, states = hook_epoch(stream_of[split], hooks, split, setup.dgs[split], step)
                carry, states, _ = epoch(carry, states)
                setup.hm.adopt_states(split, states)
        except WindowClosed:
            return
