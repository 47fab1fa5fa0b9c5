"""The card's own trace of a run, from ``torch.profiler`` (CUPTI), kept in memory.

:func:`record` profiles a region (CPU and CUDA activity, no shapes, no
stacks) inside a ``portbench.window`` annotation and returns a
:class:`Trace`: the kernels, memcpys and memsets that ran on the device and
the host's ops, as plain :class:`Event` s in seconds. Nothing is written to
disk. The per-layer metric readers (``portbench/metrics``) and the
breakdown read a :class:`Trace`, so their tests build one from events
written by hand.
"""

from __future__ import annotations

import heapq
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Iterable, List, Tuple

WINDOW = "portbench.window"
DEVICE_KINDS = ("kernel", "memcpy", "memset")
_ACTIVITY = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset",
             "cpu_op": "host", "user_annotation": "host", "cuda_runtime": "host",
             "cuda_driver": "host", "python_function": "host"}
NAME_CHARS = 120


@dataclass(frozen=True)
class Event:
    name: str
    kind: str  # kernel | memcpy | memset | host
    start: float  # seconds
    end: float


def _kind(ev) -> str | None:
    """``kernel``, ``memcpy``, ``memset``, ``host``, or ``None`` for what no metric reads.

    Torch builds without ``activity_type`` tell a record by its device and
    name; a user annotation's copy on the device's timeline is no device work.
    """
    activity = getattr(ev, "activity_type", None)
    if activity is not None:
        return _ACTIVITY.get(activity())
    if str(ev.device_type()).endswith("CPU"):
        return "host"
    if getattr(ev, "is_user_annotation", None) is not None and ev.is_user_annotation():
        return None
    name = ev.name()
    return "memcpy" if name.startswith("Memcpy") else "memset" if name.startswith("Memset") \
        else "kernel"


def _union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class Trace:
    """Device and host events of one traced window."""

    def __init__(self, events: List[Event], window: Tuple[float, float]):
        self.window = window
        lo, hi = window
        self.device = [e for e in events if e.kind in DEVICE_KINDS and e.end > lo and e.start < hi]
        self.host = [e for e in events if e.kind == "host"]
        self._busy = _union((max(e.start, lo), min(e.end, hi)) for e in self.device)

    @classmethod
    def from_events(cls, events: List[Event]) -> "Trace":
        marks = [e for e in events if e.kind == "host" and e.name == WINDOW]
        if not marks:
            raise ValueError(f"no {WINDOW!r} annotation in the trace")
        return cls(events, (marks[0].start, marks[0].end))

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which a kernel, memcpy or memset ran on the device."""
        return sum(e - s for s, e in self._busy)

    def kernels(self, match: Callable[[str], bool] = lambda name: True) -> List[Event]:
        return [e for e in self.device if e.kind == "kernel" and match(e.name)]

    def of_kind(self, kind: str) -> List[Event]:
        return [e for e in self.device if e.kind == kind]

    def idle_gaps(self) -> List[Tuple[float, float]]:
        """The intervals of the window in which nothing ran on the device."""
        lo, hi = self.window
        edges = [lo] + [t for span in self._busy for t in span] + [hi]
        return [(s, e) for s, e in zip(edges[::2], edges[1::2]) if e > s]

    def breakdown(self, top: int = 10) -> dict:
        """Device time by operation, and idle time by the innermost host op running in each gap."""
        by_op = defaultdict(float)
        for e in self.device:
            by_op[e.name[:NAME_CHARS]] += e.end - e.start
        by_host = defaultdict(float)
        gaps = sorted(self.idle_gaps(), key=lambda g: (g[0] + g[1]) / 2)
        host = sorted(self.host, key=lambda e: e.start)
        active: list = []  # (duration, index): the shortest host op that has begun
        i = 0
        for s, e in gaps:
            mid = (s + e) / 2
            while i < len(host) and host[i].start <= mid:
                heapq.heappush(active, (host[i].end - host[i].start, i))
                i += 1
            while active and host[active[0][1]].end < mid:
                heapq.heappop(active)  # ended before this gap, so before every later one
            name = host[active[0][1]].name[:NAME_CHARS] if active else "(no host op)"
            by_host[name] += e - s
        return {"device_ops": _top(by_op, top), "idle_gaps": _top(by_host, top)}


def _top(seconds: dict, n: int) -> list:
    return sorted(([k, v] for k, v in seconds.items()), key=lambda kv: -kv[1])[:n]


def record(fn: Callable[[], object], cuda: bool = True):
    """Run ``fn`` under the profiler, inside the window annotation; returns ``(fn(), Trace)``.

    ``cuda`` adds the device's activity and waits for it inside the window.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            result = fn()
            if cuda:
                torch.cuda.synchronize()
    events = []
    for ev in prof.profiler.kineto_results.events():
        kind = _kind(ev)
        if kind is None:
            continue
        start = ev.start_ns() * 1e-9
        events.append(Event(ev.name(), kind, start, start + ev.duration_ns() * 1e-9))
    return result, Trace.from_events(events)
