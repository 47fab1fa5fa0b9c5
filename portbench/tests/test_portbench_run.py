"""The command's refusals, the JAX check, and a cell added as data alone."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench.harness.guard import forbidden_modules
from portbench.harness.spec import BENCH, ROOT, load_cell, load_json, readers

RUN = ["python3", "portbench/run.py", "--workload", "ens.f32.b2", "--seed", "3000000017",
       "--seconds", "1", "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run(RUN, cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    """Without a visible card the command fails and prints no result: it never runs on the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(ROOT, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "needs 1 CUDA card" in out.stderr


def test_outside_a_checkout_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files has no program to run."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "skillful_nowcasting_tpu_torch" in out.stderr


@pytest.mark.parametrize("names, found", [
    (["jax"], ["jax"]),
    (["jax.numpy", "numpy"], ["jax.numpy"]),
    (["skillful_nowcasting_tpu", "skillful_nowcasting_tpu.dgmr"],
     ["skillful_nowcasting_tpu", "skillful_nowcasting_tpu.dgmr"]),
    (["skillful_nowcasting_tpu_torch", "skillful_nowcasting_tpu_torch.dgmr", "torch"], []),
    (["flax.linen", "optax", "orbax.checkpoint", "jaxlib.xla_client"],
     ["flax.linen", "jaxlib.xla_client", "optax", "orbax.checkpoint"]),
    (["jaxtyping", "flaxen"], []),
])
def test_jax_check_compares_whole_top_level_names(names, found):
    assert forbidden_modules(names) == found


def test_this_process_loads_no_jax():
    import portbench.harness.runner  # noqa: F401
    import portbench.reference.dgmr  # noqa: F401

    assert forbidden_modules(sys.modules) == []


def test_a_bf16_ensemble_cell_is_one_entry():
    """``ens.bf16.b2`` (an open question) needs a workloads entry and metrics' lists, no file."""
    bench = load_json(ROOT / "BENCHMARK.json")
    bench["workloads"].append({"name": "ens.bf16.b2", "config": "dgmr-256-bf16",
                               "traffic": "ensemble", "chips": 1, "why": "bf16 requests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "ens.f32.b2" in m.get("workloads", []):
            m["workloads"].append("ens.bf16.b2")
    cell = load_cell("ens.bf16.b2", bench)
    assert cell.config["dtype"] == "bfloat16" and cell.traffic["kind"] == "ensemble"
    assert {m["name"] for m in cell.end_to_end} == {"frames_per_s", "setup_s"}
    assert set(readers(cell.per_layer)) == {m["name"] for m in bench["per_layer"]
                                           if m["name"].endswith(".frames")}


def test_benchmark_names_its_files():
    bench = load_json(ROOT / "BENCHMARK.json")
    for c in bench["configs"]:
        assert (ROOT / c["file"]).exists() and c["file"] == f"portbench/configs/{c['name']}.json"
    for w in bench["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert json.loads((ROOT / f"portbench/configs/{w['config']}.json").read_text())["limits"]
