"""What every kind of cell hands back to ``run.py``, and the measured
window's frame: the clock, the collector paused, and with ``--trace 1``
the profiler with the span ``window`` around it."""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch


class RunData:
    """What the metric readers read (``metrics/<name>.py``)."""

    def __init__(self, **kw) -> None:
        self.__dict__.update(kw)


@dataclass
class CellRun:
    numbers: Dict[str, float]  # each number compared, by the name in limits/<cell>.json
    attempted: int
    failed: int
    data: RunData
    peak_bytes: int
    summary: Optional[object] = None  # trace.TraceSummary of a traced run
    info: Dict[str, float] = field(default_factory=dict)


class Window:
    """``with Window(trace, device) as w:`` around the measured work; then
    ``w.seconds`` and, for a traced run on the card, ``w.summary()``."""

    def __init__(self, trace: bool, device: torch.device) -> None:
        self.trace, self.cuda = trace, device.type == "cuda"
        self.prof = self.span = None
        self.t0 = self.t1 = 0.0

    def __enter__(self) -> "Window":
        if self.trace:
            from torch.profiler import ProfilerActivity, profile, record_function

            acts: List = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self.span = record_function("window")
            self.span.__enter__()
        gc.collect()
        gc.disable()  # no collector pauses inside the window (timeit does the same)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        try:
            if self.cuda:
                torch.cuda.synchronize()
            self.t1 = time.perf_counter()
        finally:
            gc.enable()
            if self.trace:
                self.span.__exit__(None, None, None)
                self.prof.__exit__(None, None, None)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def summary(self):
        if not (self.trace and self.cuda):
            return None
        from . import trace as tr

        return tr.reduce(self.prof)
