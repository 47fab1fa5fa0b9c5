"""Tracing and profiling (port of ``skillful_nowcasting_tpu/profiling.py``).

* :func:`trace`: ``torch.profiler`` over a region (CPU, and CUDA where the
  model runs on the card), written as a Chrome trace;
* :func:`enable_nan_checks`: ``torch.autograd.set_detect_anomaly``, which
  raises where a backward produces NaN (the reference left it on always,
  quirk Q8; here it is off unless asked for);
* :func:`annotate`: ``torch.profiler.record_function``, so a block shows
  up by name in a trace;
* :func:`start_server`: raises, because torch has no profiler server.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"


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


annotate = record_function
