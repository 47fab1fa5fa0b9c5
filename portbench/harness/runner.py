"""One run of one cell: set-up, the measured (or traced) window, the check against the reference.

:func:`run_cell` does everything but the look for a card and the printing,
so that tests can drive it on the CPU at a small size, with the timed path
broken underneath.

Set-up: the weights drawn on the device from ``--seed`` in the reference
schema and loaded into the port's ``DGMR`` (built on the ``meta`` device)
with ``load_state_dict(strict=True)``; the traffic's inputs drawn; one whole
request (a whole field) run to warm every shape the window uses. The window
is a closed loop of one client: requests until ``--seconds`` have passed,
the one in flight finishing and counting. A traced run records
``trace_answers`` whole requests instead. Then the peak memory is read, the
program is freed, the weights are drawn again from the seed and the plain
reference checks a seeded sample of what the window produced.
"""

from __future__ import annotations

import gc
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from ..reference.dgmr import Numerics, Reference
from ..reference.schema import generator_schema
from .seeds import derive
from .spec import Cell, readers
from .trace import Trace, record
from .traffic import KINDS, compared
from .weights import make_state_dict

MODEL_KEYS = ("forecast_steps", "input_channels", "output_shape", "latent_channels",
              "context_channels", "num_samples", "generation_steps")
WARM_UP = -1  # the warm-up request's index: no window request shares its seed


@dataclass
class Reading:
    """What a metric reader reads: the run's counts, times and (traced) the device trace."""

    config: dict
    setup_s: float
    answers: int  # whole requests (fields) completed in the window
    window_s: float  # from the window's start to the end of the last one completed
    latencies: List[float]  # host seconds of each request
    frames: int  # nowcast frames one request brings to the host
    forwards: List[int]  # the batch of each model forward of one request
    least_work: Dict[str, int]  # context stacks, latent stacks, sampler passes one request needs
    trace: Optional[Trace] = None

    @property
    def elem(self) -> int:
        """Bytes of an element of the configuration's compute dtype."""
        return torch.finfo(getattr(torch, self.config["dtype"])).bits // 8


@dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    metrics: Dict[str, dict]
    device: dict
    checks: Dict[str, dict]
    rows: List[dict] = field(default_factory=list)
    breakdown: Optional[dict] = None
    latencies: List[float] = field(default_factory=list)

    def line(self) -> dict:
        out = {"correct": self.correct, "attempted": self.attempted, "failed": self.failed,
               "metrics": self.metrics, "device": self.device}
        if self.breakdown is not None:
            out["breakdown"] = self.breakdown
        out["checks"] = self.checks
        return out


def set_precision(config: dict) -> None:
    """The TF32 flags as the configuration states them."""
    torch.backends.cudnn.allow_tf32 = bool(config["allow_tf32"]["cudnn"])
    torch.backends.cuda.matmul.allow_tf32 = bool(config["allow_tf32"]["matmul"])


def build_port(config: dict, sd: Dict[str, torch.Tensor], device):
    """The port's ``DGMR`` in eval mode, holding ``sd``'s tensors.

    The reference schema is the generator's; the discriminator, which no
    nowcast runs, gets zeros of the shapes the port declares, so the load
    stays strict: a generator key that either side lacks raises.
    """
    from skillful_nowcasting_tpu_torch.dgmr import DGMR
    from skillful_nowcasting_tpu_torch.hub.pretrained import build_module

    model = build_module(DGMR, {k: config[k] for k in MODEL_KEYS})
    full = dict(sd)
    for key, t in model.state_dict().items():
        if key not in full:
            if not key.startswith("discriminator."):
                raise KeyError(f"the port's DGMR has {key!r}, which the reference schema lacks")
            full[key] = torch.zeros(t.shape, dtype=t.dtype, device=device)
    model.load_state_dict(full, strict=True, assign=True)
    return model.eval()


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them ("unknown" without it)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "unknown"


def _sync(cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device="cuda",
             origin: Optional[float] = None) -> Result:
    """One run of ``cell``; ``origin`` is the process's start on ``time.perf_counter``'s clock."""
    origin = time.perf_counter() if origin is None else origin
    config, mix = cell.config, cell.traffic
    device = torch.device(device)
    cuda = device.type == "cuda"
    dtype = getattr(torch, config["dtype"])
    set_precision(config)
    schema = generator_schema(config)
    weight_seed = derive(seed, "weights")
    read = readers(cell.per_layer if traced else cell.end_to_end)

    driver = KINDS[mix["kind"]](config, mix, seed, device, dtype)
    model = build_port(config, make_state_dict(schema, weight_seed, device), device)
    driver.attach(model)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    driver.request(WARM_UP)
    _sync(cuda)
    setup_s = time.perf_counter() - origin

    outputs, latencies = {}, []
    failed = 0

    def one(k: int) -> None:
        nonlocal failed
        start = time.perf_counter()
        try:
            out = driver.request(k)
        except Exception:  # a failed request counts; the client goes on
            failed += 1
            traceback.print_exc(file=sys.stderr)
            return
        latencies.append(time.perf_counter() - start)
        if driver.keep(k):
            outputs[k] = out

    tr = None
    if traced:
        def answers():
            for k in range(mix["trace_answers"]):
                one(k)

        _, tr = record(answers, cuda)
        attempted, window_s = mix["trace_answers"], tr.window_s
    else:
        start = time.perf_counter()
        attempted, end = 0, start
        while time.perf_counter() - start < seconds:
            one(attempted)
            attempted += 1
            end = time.perf_counter()
        window_s = end - start
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    driver.detach()
    del model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    reading = Reading(config, setup_s, len(latencies), window_s, latencies, driver.frames(),
                      driver.forwards(), driver.least_work(), tr)
    metrics = {}
    for m in cell.per_layer if traced else cell.end_to_end:
        value = read[m["name"]](reading)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    ref = Reference(make_state_dict(schema, weight_seed, device), config["forecast_steps"],
                    Numerics("f32"))
    rows = driver.check(outputs, ref) if outputs else []
    numbers = compared(rows) if rows else {}
    checks = {name: {"value": numbers.get(name), "limit": limit}
              for name, limit in config["limits"].items()}
    correct = bool(rows) and failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())

    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": 1, "memory_peak_bytes": int(peak)}
    if cuda:
        dev["power"] = power_limit()
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
    return Result(correct, attempted, failed, metrics, dev, checks, rows,
                  tr.breakdown() if tr is not None else None, latencies)

