"""Finding a cell's files by the names in ``BENCHMARK.json``.

* configuration ``<c>``: ``portbench/configs/<c>.json``;
* traffic mix ``<t>``: ``portbench/traffic/<t>.json``, read by the general
  generator of :mod:`.traffic` (its ``kind`` picks the entry point);
* per-layer metric ``<m>``: ``portbench/metrics/<m>.py`` if there is one,
  else the file of the name up to its last dot (``conv_ms.frames`` and
  ``conv_ms.field`` share ``metrics/conv_ms.py``; the suffix names the
  end-to-end metric that the reading moves). End-to-end metrics are read
  the same way, from ``portbench/metrics/<name>.py``. A reader module has
  ``read(reading) -> float | None`` (:class:`.runner.Reading`), and returns
  ``None`` where it finds nothing to read;
* a kernel's work: ``portbench/work/<kernel>.py``, imported by the readers.

A cell reports the end-to-end metrics whose entry lists it (or that list
no cells) and the per-layer metrics whose ``workloads`` list it.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration's file, with its name
    traffic: dict  # the mix's file, with its name
    end_to_end: List[dict]
    per_layer: List[dict]


def _listed(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, bench: dict | None = None) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json`` (or of ``bench``) with its files read."""
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[workload]
    config = {"name": w["config"], **load_json(BENCH / "configs" / f"{w['config']}.json")}
    traffic = {"name": w["traffic"], **load_json(BENCH / "traffic" / f"{w['traffic']}.json")}
    return Cell(w["name"], w["chips"], config, traffic,
                [m for m in bench["end_to_end"] if _listed(m, workload)],
                [m for m in bench["per_layer"] if _listed(m, workload)])


def metric_file(name: str) -> Path:
    """``metrics/<name>.py``, else ``metrics/<name up to its last dot>.py``."""
    own = BENCH / "metrics" / f"{name}.py"
    return own if own.exists() else BENCH / "metrics" / f"{name.rsplit('.', 1)[0]}.py"


def reader(name: str) -> Callable:
    """The ``read`` function of metric ``name``."""
    path = metric_file(name)
    if not path.exists():
        raise FileNotFoundError(f"per-layer metric {name!r}: no {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def readers(metrics: List[dict]) -> Dict[str, Callable]:
    """The ``read`` function of each metric entry, by name."""
    return {m["name"]: reader(m["name"]) for m in metrics}
