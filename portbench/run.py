"""The benchmark of skillful_nowcasting_tpu_torch on one card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` from the root of a checkout and prints
one JSON line as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` the
``breakdown``, and last ``checks``: each number compared with the reference
beside its limit, which also end standard error.

It exits non-zero and prints no result without a CUDA card (or with fewer
than the cell asks for), outside a checkout of the repository, and if any
module of JAX or of the JAX package was loaded. Kernel and compiler caches
stay in ``build/`` inside the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def process_start() -> float:
    """The process's start on ``time.perf_counter``'s clock (now, where /proc cannot say)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return now
    return now - max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))


def main(argv=None) -> int:
    origin = process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path.insert(0, str(ROOT))

    import torch

    import skillful_nowcasting_tpu_torch  # noqa: F401  (the system under test: fail early)
    from portbench.harness.guard import forbidden_modules
    from portbench.harness.runner import run_cell
    from portbench.harness.spec import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); found {have}. "
              "No result: the benchmark does not run on the CPU.", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", origin)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"portbench: JAX or the JAX package was loaded: {found}. No result.",
              file=sys.stderr)
        return 3
    if result.latencies:
        lat = sorted(result.latencies)
        print(f"portbench: {len(lat)} requests, seconds min {lat[0]:.4f} median "
              f"{lat[len(lat) // 2]:.4f} max {lat[-1]:.4f}", file=sys.stderr)
    for row in result.rows:
        print("portbench: " + json.dumps(row), file=sys.stderr)
    for name, c in result.checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result.line()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
