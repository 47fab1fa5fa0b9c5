"""The program's own spans in a traced window, for the per-layer metrics read by span.

The port records spans at its layer boundaries
(``skillful_nowcasting_tpu_torch.profiling``) while a torch profiler
records, stamped with ``time.time_ns()``, the clock of the profiler's
records, so they line up with :class:`.trace.Trace`'s events and idle gaps.
:func:`logged` reads those inside the traced window, and gives ``None``
where the program records none: the readers then report nothing.
"""

from __future__ import annotations

import bisect
from typing import Callable, List, Optional

from .trace import _union

Match = Callable[[str], bool]


def logged(r) -> Optional[List[dict]]:
    """The program's spans inside ``r``'s traced window, or ``None``.

    ``None`` where the run was untraced, the program records no spans, or
    its log dropped spans (more than it keeps were recorded).
    """
    if r.trace is None or not r.answers:
        return None
    try:
        from skillful_nowcasting_tpu_torch import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    if read is None or getattr(getattr(profiling, "LOG", None), "dropped", 0):
        return None  # no spans, or the log's ring let some go: the window's sums would fall short
    lo, hi = r.trace.window
    return read(round(lo * 1e9), round(hi * 1e9)) or None


def outermost(spans: List[dict], match: Match) -> List[dict]:
    """The spans ``match`` takes that lie inside no other span it takes (by their parents)."""
    by_id = {s["id"]: s for s in spans}
    out = []
    for s in spans:
        if not match(s["name"]):
            continue
        parent = by_id.get(s["parent"])
        while parent is not None and not match(parent["name"]):
            parent = by_id.get(parent["parent"])
        if parent is None:
            out.append(s)
    return out


def stream_ms(r, match: Match) -> Optional[float]:
    """Stream milliseconds per request of the outermost spans ``match`` takes.

    ``None`` where there are no such spans or one has no stream time (no
    CUDA events: a CPU run).
    """
    found = logged(r)
    times = [s["stream_ms"] for s in outermost(found or [], match)]
    if not times or None in times:
        return None
    return sum(times) / r.answers


def _intervals(spans: List[dict]) -> List[tuple]:
    """The union of the spans' intervals, in seconds, sorted."""
    return _union((s["t0_ns"] * 1e-9, s["t1_ns"] * 1e-9) for s in spans)


def _covers(intervals: List[tuple], t: float) -> bool:
    k = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return k >= 0 and intervals[k][0] <= t <= intervals[k][1]


def idle_ms(r, inside: Match, outside: Match = lambda name: False) -> Optional[float]:
    """Milliseconds per request of the device's idle gaps put down to spans.

    A gap counts where its midpoint lies in a span ``inside`` takes and in
    none ``outside`` takes. ``None`` where the trace has no device records
    (a CPU run) or no span is ``inside``.
    """
    found = logged(r)
    if not found or not r.trace.device:
        return None
    ins = _intervals([s for s in found if inside(s["name"])])
    if not ins:
        return None
    outs = _intervals([s for s in found if outside(s["name"])])
    total = sum(e - s for s, e in r.trace.idle_gaps()
                if _covers(ins, (s + e) / 2) and not _covers(outs, (s + e) / 2))
    return 1e3 * total / r.answers
