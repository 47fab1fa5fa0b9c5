"""Tracing and profiling (port of ``skillful_nowcasting_tpu/profiling.py``), and the port's spans.

* :func:`span`: a named region of the program (``dgmr.forward``,
  ``dgmr.tiler.upload``, ...), recorded only while a torch profiler is
  recording or inside :func:`record`; otherwise it does nothing;
* :func:`record`: ``with record(device=True) as log: ...`` records the
  spans of a block into ``log`` (a :class:`SpanLog`), which
  :meth:`SpanLog.write` writes as JSON lines;
* :func:`spans`: the spans recorded under a torch profiler, from :data:`LOG`;
* :func:`trace`: ``torch.profiler`` over a region (CPU, and CUDA where the
  model runs on the card), written as a Chrome trace, the spans in it by name;
* :func:`enable_nan_checks`: ``torch.autograd.set_detect_anomaly``, which
  raises where a backward produces NaN (the reference left it on always,
  quirk Q8; here it is off unless asked for);
* :func:`annotate`: :func:`span`, the JAX package's spelling;
* :func:`start_server`: raises, because torch has no profiler server.

A recorded span holds its name, its id, its parent's id, a request id, the
thread, and its start and end from ``time.time_ns()``, the clock of the
profiler's records. An entry span (``entry=True``: ``dgmr.generate``,
``dgmr.tiler``), or any span opened outside every other, opens a request
id; the spans inside it share that id. A span given ``device=`` (a tensor,
a ``torch.device``, or ``True`` for the current CUDA device) also records
two CUDA events on the device's current stream, at its start and end, when
that device is a CUDA one and the log keeps device time: its ``stream_ms``
is the time the stream took between them, work and idle alike, read after
a synchronize when the spans are read. Under a profiler each span is also
one of the profiler's records (a record function, by its name), so it shows
in its traces, stamped within microseconds of the span's own stamps.

While nothing records, :func:`span` returns one shared context that does
nothing: no torch call, no allocation (one flag read and a call), so the
program's layers keep their spans on the serving path. A log is a ring of
:data:`CAPACITY` spans: a long profiled session keeps the newest.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Iterator, List, Optional

import torch
from torch._C._profiler import _RecordFunctionFast as record_function  # no dispatcher op
from torch.profiler import ProfilerActivity, profile

TRACE_FILE = "trace.json"
CAPACITY = 1 << 16  # spans a log keeps

_profiler_on = torch._C._autograd._profiler_enabled
_recording: list = []  # the logs of the open record() blocks, innermost last
_local = threading.local()  # .stack: this thread's open spans
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)
_free_events: dict = collections.defaultdict(list)  # timing events to reuse, by CUDA device index
_streams: dict = {}  # torch.cuda.Stream objects by (stream id, device index, device type)


@contextlib.contextmanager
def trace(log_dir: str, *, cuda: bool | None = None) -> Iterator[profile]:
    """Profile a region: ``with trace("./profile"): run_step()`` writes ``./profile/trace.json``.

    ``cuda`` (default: whether CUDA is available) adds the device activity.
    The profiler is yielded, so the caller can read ``key_averages()``.
    """
    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def start_server(port: int = 9999):
    """Not available: ``jax.profiler.start_server`` has no torch counterpart.

    Kept so that code written against the JAX package's ``profiling`` gets
    this explanation rather than an ``AttributeError``.
    """
    raise NotImplementedError(
        "torch has no live profiler server to connect TensorBoard to; "
        "record a region with profiling.trace(log_dir) instead"
    )


def enable_nan_checks(enable: bool = True) -> None:
    """Raise where a backward pass produces NaN (``torch.autograd.set_detect_anomaly``)."""
    torch.autograd.set_detect_anomaly(enable)


class _Record:
    __slots__ = ("name", "id", "parent", "request", "thread", "t0_ns", "t1_ns", "events",
                 "stream_ms")

    def as_dict(self) -> dict:
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "request": self.request, "thread": self.thread, "t0_ns": self.t0_ns,
                "t1_ns": self.t1_ns, "stream_ms": self.stream_ms}


class SpanLog:
    """The spans recorded into one log: a ring of the newest :data:`CAPACITY`.

    ``device``: whether spans given a CUDA ``device`` record stream time.
    ``dropped`` counts the spans the ring has let go.
    """

    def __init__(self, device: bool = True):
        self.device = device
        self.dropped = 0
        self._ring: collections.deque = collections.deque(maxlen=CAPACITY)
        self._lock = threading.Lock()

    def append(self, rec: _Record) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(rec)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0

    def __len__(self) -> int:
        return len(self._ring)

    def spans(self, lo_ns: Optional[int] = None, hi_ns: Optional[int] = None) -> List[dict]:
        """The spans that began at or after ``lo_ns`` and ended by ``hi_ns``, by start.

        Each is a dict of ``name``, ``id``, ``parent``, ``request``,
        ``thread``, ``t0_ns``, ``t1_ns`` and ``stream_ms`` (``None`` without
        device events). Reading waits for the device to pass each span's end.
        """
        with self._lock:
            recs = list(self._ring)
        out = []
        for rec in recs:
            if (lo_ns is not None and rec.t0_ns < lo_ns) or (hi_ns is not None and
                                                            rec.t1_ns > hi_ns):
                continue
            if rec.events is not None:
                begin, end, index = rec.events
                rec.events = None
                end.synchronize()
                rec.stream_ms = begin.elapsed_time(end)
                _free_events[index] += (begin, end)
            out.append(rec.as_dict())
        out.sort(key=lambda s: (s["t0_ns"], s["id"]))
        return out

    def write(self, path: str) -> int:
        """Write :meth:`spans` as JSON lines, one span a line; returns how many."""
        rows = self.spans()
        with open(path, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
        return len(rows)


LOG = SpanLog()
"""Where spans go under a torch profiler, outside every :func:`record` block."""


def spans(lo_ns: Optional[int] = None, hi_ns: Optional[int] = None) -> List[dict]:
    """The spans of :data:`LOG` inside ``[lo_ns, hi_ns]`` (``time.time_ns()``); see :meth:`SpanLog.spans`."""
    return LOG.spans(lo_ns, hi_ns)


@contextlib.contextmanager
def record(device: bool = False) -> Iterator[SpanLog]:
    """Record every thread's spans while the block runs, into the :class:`SpanLog` yielded.

    ``device=True`` adds stream time to the spans that name a CUDA device.
    Blocks nest: a span goes to the innermost open one.
    """
    log = SpanLog(device)
    _recording.append(log)
    try:
        yield log
    finally:
        _recording.remove(log)


def _stream(device) -> Optional["torch.cuda.Stream"]:
    """``torch.cuda.current_stream(device)`` for a CUDA ``device``, else ``None``.

    The stream objects are kept by id: ``current_stream`` builds a new one
    each call, which costs more than the rest of a span on the card's host.
    """
    if isinstance(device, torch.Tensor):
        device = device.device
    elif device is True:
        device = torch.device("cuda") if torch.cuda.is_initialized() else None
    if not isinstance(device, torch.device) or device.type != "cuda":
        return None
    index = torch.cuda.current_device() if device.index is None else device.index
    key = torch._C._cuda_getCurrentStream(index)  # (stream id, device index, device type)
    stream = _streams.get(key)
    if stream is None:
        stream = _streams[key] = torch.cuda.Stream(stream_id=key[0], device_index=key[1],
                                                   device_type=key[2])
    return stream


def _event(stream) -> "torch.cuda.Event":
    try:
        ev = _free_events[stream.device_index].pop()
    except IndexError:
        ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


def _open_spans() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "device", "entry", "_log", "_rec", "_fn", "_stream")

    def __init__(self, name: str, device, entry: bool):
        self.name, self.device, self.entry = name, device, entry

    def __enter__(self):
        self._log = _recording[-1] if _recording else LOG
        stack = _open_spans()
        parent = stack[-1] if stack else None
        rec = self._rec = _Record()
        rec.name, rec.id, rec.thread = self.name, next(_span_ids), threading.get_ident()
        rec.parent = None if parent is None else parent.id
        rec.request = next(_request_ids) if self.entry or parent is None else parent.request
        rec.events = rec.stream_ms = None
        self._stream = _stream(self.device) if self._log.device else None
        self._fn = record_function(self.name) if _profiler_on() else None
        if self._fn is not None:
            self._fn.__enter__()
        rec.t0_ns = time.time_ns()
        if self._stream is not None:
            rec.events = (_event(self._stream), None, self._stream.device_index)
        stack.append(rec)

    def __exit__(self, typ, value, tb):
        rec = self._rec
        if self._stream is not None:
            begin, _, index = rec.events
            rec.events = (begin, _event(self._stream), index)
        rec.t1_ns = time.time_ns()
        if self._fn is not None:
            self._fn.__exit__(typ, value, tb)
        _open_spans().pop()
        self._log.append(rec)
        return False


_OFF = contextlib.nullcontext()  # the span while nothing records


def _tracing_a_graph() -> bool:
    return torch.compiler.is_compiling() or torch.compiler.is_exporting()


def span(name: str, device=False, entry: bool = False):
    """``with span("dgmr.forward", device=x): ...``: a named region of the program.

    Recorded only while a torch profiler records or a :func:`record` block
    is open, and never while ``torch.compile`` or ``torch.export`` traces a
    graph; otherwise the shared no-op context. ``device``: a tensor, a
    ``torch.device`` or ``True`` (the current CUDA device) whose current
    stream carries the region's work, for its stream time. ``entry``: the
    span opens a new request id (an entry point's call).
    """
    if (_recording or _profiler_on()) and not _tracing_a_graph():
        return _Span(name, device, entry)
    return _OFF


annotate = span
