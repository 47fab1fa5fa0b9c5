#!/usr/bin/env python3
"""Drive the PyTorch port's eval nowcast path once on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

1. Device: needs CUDA; prints the card's name and power limit; TF32 off.
2. Build: compiles the hand-written kernels from ``skillful_nowcasting_tpu_torch/csrc``.
3. Kernels vs their plain PyTorch versions on the card, at the main path's
   shapes: max-abs difference <= 1e-4 each; times from CUDA events.
4. The slice at full width: ``DGMR()`` (256x256, 18 steps, latent 768,
   context 384, 6 samples) with seeded random weights answers 3 requests
   through ``make_generate``; both kernels' launch counters must rise by the
   count the path implies.
5. End-to-end parity: one B=1 forward with a fixed latent on the card
   (kernels) and on the CPU (plain versions): max-abs <= 1e-3.

Any failure exits non-zero without the final line. The last two lines are a
JSON object of per-kernel results and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

KERNEL_TOL = 1e-4
SLICE_TOL = 1e-3
REQUESTS = 3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    import torch

    # 1. Device.
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"{smi} (nvidia-smi name, power.limit)"
    print(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)

    try:
        from skillful_nowcasting_tpu_torch import DGMR, _build
        from skillful_nowcasting_tpu_torch.inference import make_generate
        from skillful_nowcasting_tpu_torch.ops import (
            convgru_rollout,
            convgru_rollout_reference,
            gblock_fused,
            gblock_fused_reference,
        )
        from skillful_nowcasting_tpu_torch.utils import random_fill
    except ImportError as e:
        fail(f"the port is not importable (run from the repository root): {e}")

    # 2. Build.
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc on first use, else the cached library)")

    # 3. Kernels vs plain versions, at the main path's shapes.
    gen = torch.Generator().manual_seed(0)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    results = {}

    def compare(name, fn, ref, args, label, reps):
        out, want = fn(*args), ref(*args)
        torch.cuda.synchronize()
        err = (out - want).abs().max().item()
        ms = time_ms(torch, lambda: fn(*args), reps)
        plain_ms = time_ms(torch, lambda: ref(*args), reps)
        print(f"{name} {label}: max_abs_err {err:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if not err <= KERNEL_TOL:
            fail(f"{name} {label}: kernel differs from its plain version by {err} > {KERNEL_TOL}")
        r = results.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms
        r["plain_ms"] += plain_ms

    batch, steps = 2, 18
    for t_in, hw, c in ((1, 8, 384), (steps, 16, 192), (steps, 32, 96), (steps, 64, 48)):
        s = (9 * c) ** -0.5  # gates stay away from saturation
        args = (
            rand(t_in, batch, hw, hw, 3 * c),
            rand(batch, hw, hw, c),
            rand(3, 3, c, 2 * c, scale=s),
            rand(3, 3, c, c, scale=s),
            rand(3 * c, scale=0.1),
            steps,
        )
        compare("convgru_rollout", convgru_rollout, convgru_rollout_reference, args,
                f"T={steps} gx={tuple(args[0].shape)}", reps=5)

    n = steps * batch
    gblock_shapes = ((8, 768, 768), (16, 384, 384), (32, 192, 192), (64, 96, 96), (16, 384, 192))
    for hw, cin, cout in gblock_shapes:
        args = (
            rand(n, hw, hw, cin),
            rand(3, 3, cin, cin, scale=(9 * cin) ** -0.5),
            rand(3, 3, cin, cout, scale=(9 * cin) ** -0.5),
            rand(1, 1, cin, cout, scale=cin ** -0.5),
            1.0 + rand(cin, scale=0.1),
            rand(cin, scale=0.1),
            1.0 + rand(cin, scale=0.1),
            rand(cin, scale=0.1),
            rand(cout, scale=0.1),
            cin != cout,
        )
        compare("gblock_fused", gblock_fused, gblock_fused_reference, args,
                f"x={tuple(args[0].shape)} cout={cout}", reps=10)

    # 4. The slice at full width through make_generate.
    model = DGMR().eval()
    random_fill(model, torch.Generator().manual_seed(1))
    with torch.no_grad():  # exercise quirk Q1 and the BN fold
        pg = torch.Generator().manual_seed(2)
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                c = mod.num_features
                mod.weight.add_(0.1 * torch.randn(c, generator=pg))
                mod.bias.add_(0.05 * torch.randn(c, generator=pg))
                mod.running_mean.add_(0.05 * torch.randn(c, generator=pg))
                mod.running_var.mul_(torch.exp(0.1 * torch.randn(c, generator=pg)))
        model.latent_stack.att_block.gamma.fill_(0.5)
    model.to(dev)
    s_n, fs, size = model.num_samples, model.forecast_steps, model.output_shape
    generate = make_generate(model)
    x = torch.rand((batch, 4, 1, size, size), generator=torch.Generator().manual_seed(3)).to(dev)

    convgru_rollout.launches = 0
    gblock_fused.launches = 0
    seconds = []
    for i in range(REQUESTS):
        t0 = time.perf_counter()
        out = generate(x, torch.Generator().manual_seed(100 + i))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        if tuple(out.shape) != (s_n, batch, fs, 1, size, size):
            fail(f"request {i}: output shape {tuple(out.shape)}")
        if not bool(torch.isfinite(out).all()):
            fail(f"request {i}: non-finite output")
    launches = {"convgru_rollout": convgru_rollout.launches, "gblock_fused": gblock_fused.launches}
    forwards = REQUESTS * s_n
    expected = {"convgru_rollout": forwards * 4 * fs * 2, "gblock_fused": forwards * 4 * 2}
    print(f"launches: {launches}, expected {expected}")
    if launches != expected:
        fail(f"the main path's kernel launches {launches} differ from {expected}")
    frames = s_n * batch * fs
    rates = [frames / s for s in seconds]
    print(
        f"slice: {REQUESTS} requests of {s_n} samples x {batch} x {fs} frames at {size}^2, "
        f"seconds {[round(s, 4) for s in seconds]}, frames/s {[round(r, 2) for r in rates]} "
        f"on {card}"
    )

    # 5. End-to-end parity: the card's kernels against the CPU's plain versions.
    z = torch.randn((1, *model.latent_stack.shape), generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        y_gpu = model(x[:1], z=z.to(dev)).cpu()
        cpu_model = DGMR().eval()
        cpu_model.load_state_dict(model.state_dict())
        y_cpu = cpu_model(x[:1].cpu(), z=z)
    err = (y_gpu - y_cpu).abs().max().item()
    print(f"slice parity (card vs CPU, B=1, fixed z): max_abs_err {err:.3e}, "
          f"max |y| {y_cpu.abs().max().item():.3e}")
    if not err <= SLICE_TOL:
        fail(f"card and CPU nowcasts differ by {err} > {SLICE_TOL}")

    sources = {
        "convgru_rollout": ("skillful_nowcasting_tpu_torch/csrc/gru_rollout.cu",
                            "skillful_nowcasting_tpu/ops/pallas_gru.py:40"),
        "gblock_fused": ("skillful_nowcasting_tpu_torch/csrc/gblock_fused.cu",
                         "skillful_nowcasting_tpu/ops/pallas_gblock.py:66"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **results[name]}
        for name, (src, rep) in sources.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
