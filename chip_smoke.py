#!/usr/bin/env python3
"""Drive the PyTorch port's eval nowcast path once on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

1. Device: needs CUDA; prints the card's name and power limit; TF32 off.
2. Build: compiles the hand-written kernels from ``skillful_nowcasting_tpu_torch/csrc``
   and prints ptxas's registers, shared memory and spills per kernel.
3. Kernels vs their plain PyTorch versions on the card, at the main path's
   shapes: max-abs difference <= 1e-4 each, the same bits on a second call;
   times from CUDA events, beside the bound (the larger of FLOPs at the 3xTF32
   tensor-core peak and bytes at the memory peak).
4. The slice at full width: ``DGMR()`` (on the card by default; 256x256, 18
   steps, latent 768, context 384, 6 samples) with seeded random weights
   answers 3 requests through ``make_generate`` from a CPU batch; both
   kernels' launch counters must rise by the count the path implies (one
   rollout launch per ConvGRU level, two per GBlock).
5. End-to-end parity: one B=1 forward with a fixed latent on the card
   (kernels) and on the CPU (plain versions): max-abs <= 1e-3.
6. Where the time goes: one per-sample request with every layer bracketed by
   ``torch.cuda.synchronize()``, each layer's share of that request's wall.

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
# Published H100 SXM peaks (dense). 3xTF32 does three TF32 products per f32 product.
PEAK_3XTF32 = 495e12 / 3
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
PEAK_NAME = "3xTF32 tensor cores, 495/3 TFLOP/s; HBM 3.35 TB/s"


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


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least milliseconds for the work at the card's peaks, and which peak binds."""
    by_ops, by_bytes = flops / PEAK_3XTF32, nbytes / PEAK_BYTES
    return 1e3 * max(by_ops, by_bytes), "operations" if by_ops >= by_bytes else "bytes"


def gru_work(t_in: int, b: int, hw: int, c: int, steps: int) -> tuple[float, float]:
    """FLOPs and bytes of one rollout: 18 steps of conv3(h, k_ru) and conv3(r*h, k_c)."""
    m = b * hw * hw
    flops = steps * 2.0 * m * 9 * c * 3 * c
    floats = 9 * c * 3 * c + 3 * c + t_in * m * 3 * c + m * c + steps * m * c
    return flops, 4.0 * floats


def gblock_work(n: int, hw: int, cin: int, cout: int) -> tuple[float, float]:
    """FLOPs and bytes of one eval GBlock: two 3x3 convs (+ the 1x1 shortcut)."""
    m = n * hw * hw
    sc = cin != cout
    flops = 2.0 * m * 9 * cin * (cin + cout) + (2.0 * m * cin * cout if sc else 0.0)
    floats = m * (cin + cout) + 9 * cin * (cin + cout) + (cin * cout if sc else 0) + 4 * cin + cout
    return flops, 4.0 * floats


def layer_times(torch, model, x, card: str) -> None:
    """One per-sample request with every layer bracketed by synchronize(); shares of its wall."""
    import skillful_nowcasting_tpu_torch.layers.convgru as convgru_mod
    import skillful_nowcasting_tpu_torch.models.common as common_mod
    from skillful_nowcasting_tpu_torch.inference import make_generate

    totals: dict[str, float] = {}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            totals[name] = totals.get(name, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    sampler = model.sampler
    groups = {
        "conditioning_stack": [model.conditioning_stack],
        "latent_stack": [model.latent_stack],
        "convgru (gx convs + rollout)": [getattr(sampler, f"convGRU{i}") for i in range(1, 5)],
        "gblock g1..g4 (fold + kernel)": [getattr(sampler, f"g{i}") for i in range(1, 5)],
        "upsample_gblock up_g1..up_g4": [getattr(sampler, f"up_g{i}") for i in range(1, 5)],
        "sn 1x1 convs": [getattr(sampler, n) for n in
                         ("gru_conv_1x1", "gru_conv_1x1_2", "gru_conv_1x1_3", "gru_conv_1x1_4")],
        "head (bn, 1x1)": [sampler.bn, sampler.conv_1x1],
    }
    saved = []
    for name, mods in groups.items():
        for mod in mods:
            saved.append((mod, mod.forward))
            mod.forward = timed(name, mod.forward)
    rollout, gblock = convgru_mod.convgru_rollout, common_mod.gblock_fused
    convgru_mod.convgru_rollout = timed("rollout kernel", rollout)
    common_mod.gblock_fused = timed("gblock kernel", gblock)
    generate = make_generate(model)
    try:
        generate(x, torch.Generator().manual_seed(7))  # warm-up
        totals.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate(x, torch.Generator().manual_seed(8))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for mod, fwd in saved:
            mod.forward = fwd
        convgru_mod.convgru_rollout, common_mod.gblock_fused = rollout, gblock
    for name, sec in totals.items():
        print(f"layer {name}: {1e3 * sec:.3f} ms, {100 * sec / wall:.1f}% of the synchronized wall")
    print(f"layer wall: {1e3 * wall:.3f} ms on {card}")


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
    print(smi)
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
    for line in _build.ptxas_report().splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")

    # 3. Kernels vs plain versions, at the main path's shapes.
    gen = torch.Generator().manual_seed(0)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    results = {}

    def compare(name, fn, ref, args, label, reps, work):
        out, want = fn(*args), ref(*args)
        again = fn(*args)
        torch.cuda.synchronize()
        err = (out - want).abs().max().item()
        if not torch.equal(out, again):
            fail(f"{name} {label}: two calls on the same inputs gave different bits")
        ms = time_ms(torch, lambda: fn(*args), reps)
        plain_ms = time_ms(torch, lambda: ref(*args), reps)
        bound_ms, bound_by = bound(*work)
        print(
            f"{name} {label}: max_abs_err {err:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}), {work[0] / ms / 1e9:.2f} TFLOP/s, "
            f"{100 * bound_ms / ms:.1f}% of bound"
        )
        if not err <= KERNEL_TOL:
            fail(f"{name} {label}: kernel differs from its plain version by {err} > {KERNEL_TOL}")
        r = results.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                      "bound_ms": 0.0, "bound_by": bound_by,
                                      "peak": PEAK_NAME, "library_ms": None})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["bound_ms"] += bound_ms

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
                f"T={steps} gx={tuple(args[0].shape)}", reps=20,
                work=gru_work(t_in, batch, hw, c, steps))

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
                f"x={tuple(args[0].shape)} cout={cout}", reps=20,
                work=gblock_work(n, hw, cin, cout))

    # 4. The slice at full width through make_generate, from a CPU batch.
    model = DGMR().eval()
    random_fill(model, torch.Generator().manual_seed(1))
    with torch.no_grad():  # exercise quirk Q1 and the BN fold
        pg = torch.Generator().manual_seed(2)
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                c = mod.num_features
                noise = lambda sd: (sd * torch.randn(c, generator=pg)).to(dev)  # noqa: E731
                mod.weight.add_(noise(0.1))
                mod.bias.add_(noise(0.05))
                mod.running_mean.add_(noise(0.05))
                mod.running_var.mul_(torch.exp(noise(0.1)))
        model.latent_stack.att_block.gamma.fill_(0.5)
    if {p.device for p in model.parameters()} != {dev}:
        fail("DGMR() did not build its parameters on the card")
    s_n, fs, size = model.num_samples, model.forecast_steps, model.output_shape
    generate = make_generate(model)
    x = torch.rand((batch, 4, 1, size, size), generator=torch.Generator().manual_seed(3))

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
        if out.device != dev:
            fail(f"request {i}: output on {out.device}, not on the card")
        if not bool(torch.isfinite(out).all()):
            fail(f"request {i}: non-finite output")
    launches = {"convgru_rollout": convgru_rollout.launches, "gblock_fused": gblock_fused.launches}
    forwards = REQUESTS * s_n
    expected = {"convgru_rollout": forwards * 4, "gblock_fused": forwards * 4 * 2}
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
        y_gpu = model(x[:1].to(dev), z=z.to(dev)).cpu()
        cpu_model = DGMR(device="cpu").eval()
        cpu_model.load_state_dict(model.state_dict())
        y_cpu = cpu_model(x[:1].cpu(), z=z)
    err = (y_gpu - y_cpu).abs().max().item()
    print(f"slice parity (card vs CPU, B=1, fixed z): max_abs_err {err:.3e}, "
          f"max |y| {y_cpu.abs().max().item():.3e}")
    if not err <= SLICE_TOL:
        fail(f"card and CPU nowcasts differ by {err} > {SLICE_TOL}")

    # 6. Where the time goes.
    layer_times(torch, model, x.to(dev), card)

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
