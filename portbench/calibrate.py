"""The readings a cell's limits are set from: the program's on many seeds, the control's on a few.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,...,12 \
        --control-seeds 21,22,23 [--json out.json]

In one process, for each seed: the weights and inputs a run draws from it,
the requests a run compares (``check_answers`` requests, or the tiles of
``check_fields`` fields) through the port, and the plain reference on them:
each compared number over those answers is that seed's lower reading. For
each control seed the control (the reference computed in the
configuration's ``control`` numerics: TF32 for float32, float8 for
bfloat16) is compared with the reference on the same answers: its readings
are the upper ones. Prints one JSON line per seed and a summary; runs on the
card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, control: bool, device) -> dict:
    import torch

    from portbench.harness.runner import WARM_UP, build_port, set_precision
    from portbench.harness.seeds import derive
    from portbench.harness.traffic import KINDS, compared
    from portbench.harness.weights import make_state_dict
    from portbench.reference.dgmr import Numerics, Reference
    from portbench.reference.schema import generator_schema

    config, mix = cell.config, cell.traffic
    set_precision(config)
    dtype = getattr(torch, config["dtype"])
    schema = generator_schema(config)
    weight_seed = derive(seed, "weights")
    driver = KINDS[mix["kind"]](config, mix, seed, device, dtype)
    outputs, t0 = {}, time.perf_counter()
    if mix["kind"] == "field":
        keys = sorted(driver.checked)
    else:
        keys = list(range(mix["check_answers"]))
    if control:
        outputs = {k: None for k in keys}
    else:
        model = build_port(config, make_state_dict(schema, weight_seed, device), device)
        driver.attach(model)
        driver.request(WARM_UP)
        for k in keys:
            outputs[k] = driver.request(k)
        driver.detach()
        del model
    program_s = time.perf_counter() - t0
    sd = make_state_dict(schema, weight_seed, device)
    ref = Reference(sd, config["forecast_steps"], Numerics("f32"))
    ctrl = Reference(sd, config["forecast_steps"], Numerics(config["control"])) if control else None
    t0 = time.perf_counter()
    rows = driver.check(outputs, ref, ctrl)
    worst = max(rows, key=lambda r: r["gap"] / max(r["peak"], 1e-300))
    return {"seed": seed, "side": "control" if control else "program", **compared(rows),
            "answers": len(rows), "worst_answer": worst["answer"], "program_s": program_s,
            "reference_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated program seeds")
    p.add_argument("--control-seeds", default="", help="comma-separated control seeds")
    p.add_argument("--json", help="also write every reading to this file")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from portbench.harness.spec import load_cell

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    out = []
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for s in filter(None, seeds.split(",")):
            row = readings(cell, int(s), control, torch.device("cuda"))
            print(json.dumps(row), flush=True)
            out.append(row)
    summary = {}
    for name in sorted(cell.config["limits"]):
        prog = [r[name] for r in out if r["side"] == "program"]
        ctrl = [r[name] for r in out if r["side"] == "control"]
        summary[name] = {"lower": max(prog) if prog else None, "upper": min(ctrl) if ctrl else None,
                         "limit": cell.config["limits"][name]}
    print(json.dumps({"workload": cell.name, "summary": summary}), flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps({"readings": out, "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
