"""The readers of the program's spans: on a trace and a span log written by hand, and a CPU run.

The hand-built window is 100 ms from a Unix-time origin (the profiler's
clock): kernels at 0-10, 12-30 and 40-50 ms and a memcpy at 60-70 ms leave
idle gaps at 10-12, 30-40, 50-60 and 70-100 ms.
"""

from __future__ import annotations

import pytest

from portbench.harness.runner import run_cell
from portbench.harness.spans import outermost
from portbench.harness.spec import reader
from portbench.harness.trace import WINDOW, Event, Trace
from portbench.tests.test_portbench_metrics import reading
from portbench.tests.tiny import tiny_cell
from skillful_nowcasting_tpu_torch import profiling

T0 = 1_700_000_000.0  # seconds
MS = 1e-3
US = 1e-3  # in ms: the trace's float seconds at Unix time resolve 0.24 µs
NEW = {"ens.f32.b2": ["forward_idle_ms.frames", "derive_ms.frames", "convgru_ms.frames",
                      "upsample_ms.frames"],
       "conus.bf16": ["tiler_idle_ms.field", "forward_idle_ms.field", "derive_ms.field",
                      "convgru_ms.field", "upsample_ms.field"]}


def trace(device=True) -> Trace:
    ev = [Event(WINDOW, "host", T0, T0 + 100 * MS)]
    if device:
        ev += [Event("conv", "kernel", T0, T0 + 10 * MS),
               Event("add", "kernel", T0 + 12 * MS, T0 + 30 * MS),
               Event("gru", "kernel", T0 + 40 * MS, T0 + 50 * MS),
               Event("Memcpy HtoD", "memcpy", T0 + 60 * MS, T0 + 70 * MS)]
    return Trace.from_events(ev)


def _span(i, name, t0_ms, t1_ms, parent=None, stream_ms=None):
    ns = round(T0 * 1e9)
    return {"name": name, "id": i, "parent": parent, "request": 1, "thread": 7,
            "t0_ns": ns + round(t0_ms * 1e6), "t1_ns": ns + round(t1_ms * 1e6),
            "stream_ms": stream_ms}


LOG = [
    _span(1, "dgmr.tiler", 0, 100),
    _span(2, "dgmr.tiler.gather", 9, 13, 1),  # holds the gap at 10-12
    _span(3, "dgmr.forward", 13, 54, 1, 41.0),  # holds 30-40, not 50-60
    _span(4, "dgmr.derive.gblock", 14, 16, 3, 3.0),
    _span(5, "dgmr.derive.sn", 14.5, 15, 4, 1.0),  # inside the gblock derivation
    _span(6, "dgmr.derive.sn", 15, 15.5, 4, 1.0),
    _span(7, "dgmr.derive.sn", 17, 18, 3, 0.5),
    _span(8, "dgmr.convgru", 18, 25, 3, 4.0),
    _span(9, "dgmr.derive.rollout", 18, 19, 8, 2.0),
    _span(10, "dgmr.convgru", 25, 32, 3, 6.0),
    _span(11, "dgmr.tiler.fetch", 33, 36, 1),  # inside the forward's time: not the tiler's
    _span(12, "dgmr.tiler.host_buffer", 54, 99, 1),  # holds 50-60 and 70-100
    _span(13, "dgmr.convgru", 120, 130, None, 50.0),  # after the window
]


@pytest.fixture
def spans(monkeypatch):
    """The program's span log, as ``profiling.spans`` reads it."""
    def read(lo_ns, hi_ns):
        return [s for s in LOG if s["t0_ns"] >= lo_ns and s["t1_ns"] <= hi_ns]

    monkeypatch.setattr(profiling, "spans", read)


def read(name, r):
    return reader(name)(r)


def test_idle_gaps_go_to_the_spans_their_midpoints_lie_in(spans):
    r = reading(trace(), answers=2)
    assert read("tiler_idle_ms.field", r) == pytest.approx((2 + 10 + 30) / 2, abs=US)
    assert read("forward_idle_ms.frames", r) == pytest.approx(10 / 2, abs=US)


def test_stream_time_of_the_outermost_spans_per_request(spans):
    r = reading(trace(), answers=2)
    assert read("derive_ms.field", r) == pytest.approx((3.0 + 0.5 + 2.0) / 2)
    assert read("convgru_ms.frames", r) == pytest.approx((4.0 + 6.0) / 2)  # not the one after
    assert read("upsample_ms.field", r) is None  # no such span


def test_outermost_follows_the_parents():
    found = outermost(LOG, lambda name: name.startswith("dgmr.derive."))
    assert [s["id"] for s in found] == [4, 7, 9]


def test_nothing_to_read(spans, monkeypatch):
    assert read("derive_ms.frames", reading(None)) is None  # untraced
    assert read("forward_idle_ms.field", reading(trace(device=False))) is None  # no device
    no_stream = [dict(s, stream_ms=None) for s in LOG]
    monkeypatch.setattr(profiling, "spans", lambda lo, hi: no_stream)
    assert read("convgru_ms.field", reading(trace())) is None  # no CUDA events (a CPU run)
    monkeypatch.delattr(profiling, "spans")  # a program that records no spans
    for name in NEW["conus.bf16"]:
        assert read(name, reading(trace())) is None


def test_a_log_that_dropped_spans_reads_nothing(spans, monkeypatch):
    r = reading(trace(), answers=2)
    assert read("derive_ms.field", r) is not None
    monkeypatch.setattr(profiling.LOG, "dropped", 1)  # the ring let a span go
    for name in NEW["conus.bf16"]:
        assert read(name, r) is None


@pytest.mark.parametrize("name", sorted(NEW))
def test_a_cpu_traced_run_logs_the_spans(name):
    """A tiny traced run on the CPU: the spans are logged, but it has no device records or
    stream time, so every new metric reads nothing (it needs the card)."""
    cell = tiny_cell(name)
    assert set(NEW[name]) <= {m["name"] for m in cell.per_layer}
    profiling.LOG.clear()
    result = run_cell(cell, 3000000031, 0.5, True, "cpu")
    assert result.correct and result.breakdown is not None
    assert not set(NEW[name]) & set(result.metrics)
    names = {s["name"] for s in profiling.spans()}
    entry = "dgmr.generate" if name == "ens.f32.b2" else "dgmr.tiler"
    assert {entry, "dgmr.forward", "dgmr.convgru", "dgmr.upsample_gblock",
            "dgmr.derive.sn"} <= names
    if entry == "dgmr.tiler":
        assert {"dgmr.tiler.upload", "dgmr.tiler.gather", "dgmr.tiler.scatter"} <= names
    assert all(s["stream_ms"] is None for s in profiling.spans())
    profiling.LOG.clear()
