"""Reduction of a ``torch.profiler`` trace of the window to what the
per-layer metrics read: the device's busy time (the union of its kernel,
copy and set intervals) inside the window span, device seconds and launch
counts by kernel name, and the device's idle time by the host span that
was open when it went idle."""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

HOST_SPANS = ("stream", "hooks", "step", "restore")
SPANS = HOST_SPANS + ("window",)


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_s: Dict[str, float] = field(default_factory=dict)  # by kernel or copy name
    launches: Dict[str, int] = field(default_factory=dict)  # kernels by name
    idle_by_span: Dict[str, float] = field(default_factory=dict)

    def kernel_seconds(self, match) -> Tuple[float, int]:
        """Device seconds and launches of the kernels whose name ``match``es."""
        names = [n for n in self.device_s if match(n)]
        return sum(self.device_s[n] for n in names), sum(self.launches.get(n, 0) for n in names)


def _is_device(e) -> bool:
    """A kernel, copy or set on the card, not a span that the profiler
    mirrors onto the card's timeline."""
    return (str(e.device_type()).endswith("CUDA") and e.name() not in SPANS
            and "annotation" not in str(getattr(e, "activity_type", lambda: "")()))


def reduce(prof) -> TraceSummary:
    events = prof.profiler.kineto_results.events()
    cpu = lambda e: str(e.device_type()).endswith("CPU")
    win = [e for e in events if cpu(e) and e.name() == "window"]
    if not win:
        raise RuntimeError("the trace has no 'window' span")
    w0, w1 = win[0].start_ns(), win[0].start_ns() + win[0].duration_ns()
    dev: List[Tuple[int, int]] = []
    device_s: Dict[str, float] = defaultdict(float)
    launches: Dict[str, int] = defaultdict(int)
    spans: List[Tuple[int, int, str]] = []
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if _is_device(e):
            if s + d <= w0 or s >= w1:
                continue
            name = e.name()
            dev.append((max(s, w0), min(s + d, w1)))
            device_s[name] += (min(s + d, w1) - max(s, w0)) * 1e-9
            kind = getattr(e, "activity_type", lambda: "kernel")()
            if "memcpy" not in kind and "memset" not in kind and not name.startswith("Mem"):
                launches[name] += 1
        elif cpu(e) and e.name() in HOST_SPANS and w0 <= s < w1:
            spans.append((s, s + d, e.name()))
    dev.sort()
    merged: List[List[int]] = []
    for s, t in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged)
    # Idle gaps (before the first interval, between, after the last), each
    # charged to the host span open at its start (the spans do not nest).
    spans.sort()
    starts = [s for s, _, _ in spans]
    idle: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        j = bisect.bisect_right(starts, g0) - 1
        name = spans[j][2] if j >= 0 and spans[j][1] > g0 else "other"
        idle[name] += (g1 - g0) * 1e-9
    return TraceSummary(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9, device_s=dict(device_s),
                        launches=dict(launches), idle_by_span=dict(idle))
