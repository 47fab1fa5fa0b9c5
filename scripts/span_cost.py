#!/usr/bin/env python3
"""What the port's spans cost on one card, and whether they share the profiler's clock.

Run from the repository root: ``python3 scripts/span_cost.py [--requests 8] [--seed N]``.
It prints, beside the card's name and power limit (``nvidia-smi``):

* nanoseconds a span costs: off (nothing records), under ``profiling.record()``
  (host stamps only), under ``record(device=True)`` on a CUDA tensor (two
  CUDA events more), and under ``torch.profiler`` with CUDA activity (CUPTI);
* the milliseconds of a request of the benchmark's ``ens.f32.b2`` cell
  (the published DGMR in float32, 2 crops, 6 samples; ``portbench/``'s
  weights and inputs from ``--seed``) with tracing off, under
  ``record(device=True)`` and under the benchmark's own CUPTI trace
  (``portbench/harness/trace.py``), each request's and their medians;
* the clock: each ``dgmr.generate`` span's start and end against its record
  in the profiler's trace, in microseconds, and the spans' median duration
  against the requests' median on the host clock, with what a request adds
  after the span: the device's tail and the result's copy to the host;
* the stream milliseconds a request of the outermost spans of each name
  under ``record(device=True)``.

The last line is one JSON object with every number. It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

from portbench.harness.runner import build_port, power_limit, set_precision  # noqa: E402
from portbench.harness.seeds import derive  # noqa: E402
from portbench.harness.spans import outermost  # noqa: E402
from portbench.harness.spec import load_cell  # noqa: E402
from portbench.harness.trace import record as cupti_record  # noqa: E402
from portbench.harness.traffic import KINDS  # noqa: E402
from portbench.harness.weights import make_state_dict  # noqa: E402
from portbench.reference.schema import generator_schema  # noqa: E402
from skillful_nowcasting_tpu_torch import profiling  # noqa: E402

CELL = "ens.f32.b2"


def ns_per_span(n: int, device) -> float:
    """Nanoseconds of one ``with span(...): pass``, call included, over ``n`` in a row."""
    span = profiling.span
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with span("dgmr.cost", device=device):
            pass
    return (time.perf_counter_ns() - t0) / n


def span_costs(x: torch.Tensor) -> dict:
    from torch.profiler import ProfilerActivity, profile

    ns_per_span(10_000, x)  # warm
    out = {"off": ns_per_span(1_000_000, x), "off_host": ns_per_span(1_000_000, False)}
    with profiling.record():
        out["record_host"] = ns_per_span(100_000, False)
    with profiling.record(device=True):
        out["record_device"] = ns_per_span(20_000, x)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out["cupti_device"] = ns_per_span(20_000, x)
    torch.cuda.synchronize()
    profiling.LOG.clear()
    return out


def stream_split(spans, answers: int) -> dict:
    """Stream ms and spans a request, by name: the outermost of each (derivations as one)."""
    def key(name):
        return "dgmr.derive.*" if name.startswith("dgmr.derive.") else name

    split, counts = {}, defaultdict(float)
    for s in spans:
        counts[s["name"]] += 1 / answers
    for k in sorted({key(s["name"]) for s in spans}):
        times = [s["stream_ms"] for s in outermost(spans, lambda n: key(n) == k)]
        if times and None not in times:
            split[k] = sum(times) / answers
    return {"stream_ms": split, "spans_per_request": dict(sorted(counts.items()))}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--seed", type=int, default=3000000101)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("span_cost: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    card = power_limit()
    torch.set_num_threads(4)
    out = {"card": card, "torch": torch.__version__,
           "span_ns": span_costs(torch.ones(1, device=device))}
    print(f"span ns ({card}): {out['span_ns']}", flush=True)

    cell = load_cell(CELL)
    cfg, mix = cell.config, cell.traffic
    set_precision(cfg)
    driver = KINDS[mix["kind"]](cfg, mix, args.seed, device, getattr(torch, cfg["dtype"]))
    model = build_port(cfg, make_state_dict(generator_schema(cfg), derive(args.seed, "weights"),
                                            device), device)
    driver.attach(model)
    driver.request(-1)
    torch.cuda.synchronize()
    n = args.requests

    def timed(ks, into):
        for k in ks:
            t0 = time.perf_counter()
            driver.request(k)
            into.append(1e3 * (time.perf_counter() - t0))

    off, recorded, traced = [], [], []
    timed(range(n), off)
    with profiling.record(device=True) as log:
        timed(range(n, 2 * n), recorded)
    out["record_split"] = stream_split(log.spans(), n)
    profiling.LOG.clear()
    _, tr = cupti_record(lambda: timed(range(2 * n, 3 * n), traced), cuda=True)
    lo, hi = tr.window
    gen = [s for s in profiling.spans(round(lo * 1e9), round(hi * 1e9))
           if s["name"] == "dgmr.generate"]
    marks = sorted((e for e in tr.host if e.name == "dgmr.generate"), key=lambda e: e.start)
    out["request_ms"] = {"off": off, "record_device": recorded, "cupti": traced}
    out["request_ms_median"] = {k: statistics.median(v) for k, v in out["request_ms"].items()}
    out["clock_us"] = {
        "spans": len(gen), "records": len(marks),
        "start": [round(s["t0_ns"] * 1e-3 - e.start * 1e6, 3) for s, e in zip(gen, marks)],
        "end": [round(e.end * 1e6 - s["t1_ns"] * 1e-3, 3) for s, e in zip(gen, marks)]}
    # What a request adds after its generate span: the device's tail, then the result's copy.
    copies = sorted((e for e in tr.device if e.kind == "memcpy" and "DtoH" in e.name),
                    key=lambda e: e.start)
    after = [next((e for e in copies if e.start >= s["t1_ns"] * 1e-9), None) for s in gen]
    out["after_generate_ms"] = {
        "device_tail": [round(1e3 * (e.start - s["t1_ns"] * 1e-9), 3) for s, e in zip(gen, after)
                        if e is not None],
        "copy_to_host": [round(1e3 * (e.end - e.start), 3) for e in after if e is not None]}
    span_ms = statistics.median((s["t1_ns"] - s["t0_ns"]) * 1e-6 for s in gen) if gen else None
    out["generate_span_median_ms"] = span_ms
    out["generate_span_vs_request"] = (span_ms / out["request_ms_median"]["cupti"] - 1
                                       if span_ms else None)
    print(f"request ms medians {out['request_ms_median']}; clock {out['clock_us']}; "
          f"generate span median {span_ms} ms; after it {out['after_generate_ms']}; "
          f"split {out['record_split']}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
