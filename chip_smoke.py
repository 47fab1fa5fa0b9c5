#!/usr/bin/env python3
"""Drive the PyTorch port's nowcast, serving and training paths once on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

1. Device: needs CUDA; prints the card's name and power limit; TF32 off.
2. Build: compiles the hand-written kernels from ``skillful_nowcasting_tpu_torch/csrc``
   and prints ptxas's registers, shared memory and spills per kernel.
3. Kernels vs their plain PyTorch versions on the card, at the main paths'
   shapes: a request's batch (B=2) and the tile batch of tiled_nowcast_device
   (B=16 tiles, N=288 GBlock rows); max-abs difference <= 1e-4 each, the same
   bits on a second call; times from CUDA events, beside the bound (the
   larger of FLOPs at the 3xTF32 tensor-core peak and bytes at the memory
   peak).
4. The slice at full width: ``DGMR()`` (on the card by default; 256x256, 18
   steps, latent 768, context 384, 6 samples) with seeded random weights
   answers 3 requests through ``make_generate`` from a CPU batch; both
   kernels' launch counters must rise by the count the path implies (one
   rollout launch per ConvGRU level, two per GBlock).
5. End-to-end parity: one B=1 forward with a fixed latent on the card
   (kernels) and on the CPU (plain versions): max-abs <= 1e-3.
6. Where the time goes: one per-sample request with every layer bracketed by
   ``torch.cuda.synchronize()``, each layer's share of that request's wall.
7. Training at full width: the paper config with seeded random weights
   (``random_fill`` + ``desaturate_discriminator``), B=2 random context and
   target sequences, ``init_train_state``, 3 ``make_train_step`` steps
   (defaults: logging forward, rollout recompute) and 1 ``make_eval_step``.
   Metrics finite, G and D parameters moved, every BN running statistic and
   every used SN vector advanced, no kernel launch in a train step (train
   mode takes the plain paths, as in JAX), and exactly 4 / 8 launches per
   generator forward in the eval step. Prints seconds per step, a
   synchronized D / G / logging split of the last step and peak memory, then
   the time and peak memory of one more step without the rollout recompute.
8. Training parity, card vs CPU, at the CPU tests' tiny config: the same
   weights, the same explicit draws, SGD, one train step each. Losses,
   gradients and post-step parameters agree to max-abs <= 1e-3 of each
   tensor's max-abs (floored at 1e-6 of its group's largest: a conv bias in
   front of a train-mode BatchNorm has a true gradient of 0) in float64;
   the float32 figure is printed beside it.
9. Hub round trips at full width: ``save_pretrained`` then
   ``DGMR.from_pretrained`` onto the card; the same weights with old-style
   spectral-norm keys and ``generator.*`` copies; the three stacks saved
   apart and rejoined by ``compose_generator``. Each fixed-latent nowcast is
   bit-identical to the source model's; bytes and seconds printed.
10. A 1184x1184 field through both tilers (tile 256, overlap 64, 16 tiles a
   forward), one latent: 4 / 8 launches per forward, an interior tile of
   each against a direct forward and the tile the two tilers share against
   each other (<= 1e-4), ``fetch_stripes=3`` bit-identical to 1, the seam
   ratio printed.
11. One MRMS CONUS field, 3500x7000, 18 steps, through
   ``tiled_nowcast_device``: seconds, tiles/s, peak memory.
12. ``evaluate_nowcast`` at full width, S=6, B=2, 2 batches: finite metrics.
13. ``tiled_nowcast_device`` and ``evaluate_nowcast`` at the tiny config on
   the card and on the CPU, fixed latents: max-abs <= 1e-3.

Every path's launches are counted from 0 and must be 4 (rollout) and 8
(GBlock) per generator forward. Any failure exits non-zero without the final
line. The last two lines are a JSON object of per-kernel results and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

KERNEL_TOL = 1e-4
SLICE_TOL = 1e-3
TRAIN_TOL = 1e-3
REQUESTS = 3
TILE_BATCH = 16  # tiles per forward of tiled_nowcast_device (its default)
TILED_FIELD = 1184  # = 256 + 5 * 192 - 32: the host tiler's flush-right tile is a device tile
MRMS = (3500, 7000)  # MRMS CONUS grid
TRAIN_STEPS = 3
TINY = dict(forecast_steps=2, output_shape=64, latent_channels=256, context_channels=32,
            generation_steps=2, num_spatial_layers=2, num_temporal_layers=2)
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


def serving_model(torch, dev):
    """The paper-config ``DGMR()`` on the card: seeded weights, BN stats and gamma perturbed."""
    from skillful_nowcasting_tpu_torch import DGMR
    from skillful_nowcasting_tpu_torch.utils import random_fill

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
    return model


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


def phase_split(torch, training, run_step) -> dict:
    """Run one train step with a synchronize after each optimizer update; seconds per phase.

    The step applies D, D, then G updates; the logging forward follows.
    """
    marks = []
    apply = training._apply

    def timed_apply(*args):
        apply(*args)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    training._apply = timed_apply
    try:
        run_step()
        torch.cuda.synchronize()
    finally:
        training._apply = apply
    end = time.perf_counter()
    return {"d_phase": marks[1] - t0, "g_phase": marks[2] - marks[1],
            "logging_forward": end - marks[2], "step": end - t0}


def unused_shortcuts(model) -> set:
    """The SN 1x1 shortcut convs that the reference builds but never applies (never advance)."""
    from skillful_nowcasting_tpu_torch.models.common import DBlock, GBlock

    out = set()
    for name, mod in model.named_modules():
        conv = getattr(mod, "conv_1x1", None)
        if isinstance(mod, GBlock) and conv.in_channels == conv.out_channels:
            out.add(f"{name}.conv_1x1")
        if isinstance(mod, DBlock) and not mod.use_sc_conv:
            out.add(f"{name}.conv_1x1")
    return out


def train_full_width(torch, dev, card, launch_counters) -> dict:
    """Phase 7: 3 train steps and 1 eval step of the paper config at B=2 on the card."""
    from skillful_nowcasting_tpu_torch import DGMR, training
    from skillful_nowcasting_tpu_torch.utils import random_fill

    model = random_fill(DGMR(), torch.Generator().manual_seed(10))
    training.desaturate_discriminator(model)
    gen = torch.Generator().manual_seed(11)
    x = torch.rand((2, 4, 1, model.output_shape, model.output_shape), generator=gen)
    y = torch.rand((2, model.forecast_steps, 1, model.output_shape, model.output_shape),
                   generator=gen)
    state = training.init_train_state(model)
    step = training.make_train_step(model)
    g_params, d_params = training.split_params(model)
    params0 = {k: p.detach().clone() for k, p in model.named_parameters()}
    buffers0 = {k: b.clone() for k, b in model.named_buffers()}

    for counter in launch_counters:
        counter.launches = 0
    torch.cuda.reset_peak_memory_stats()
    seconds, split = [], None
    for i in range(TRAIN_STEPS):
        draw = torch.Generator().manual_seed(200 + i)
        if i == TRAIN_STEPS - 1:
            holder = {}
            split = phase_split(torch, training,
                                lambda: holder.update(m=step(state, x, y, draw)))
            metrics = holder["m"]
            seconds.append(split["step"])
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(state, x, y, draw)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        values = {k: v.item() for k, v in metrics.items()}
        print(f"train step {i + 1}: {json.dumps(values)}")
        if not all(math.isfinite(v) for v in values.values()):
            fail(f"train step {i + 1}: non-finite metrics {values}")
    peak = torch.cuda.max_memory_allocated()
    train_launches = {c.__name__: c.launches for c in launch_counters}
    print(f"train launches over {TRAIN_STEPS} steps: {train_launches} (expected 0 each)")
    if any(train_launches.values()):
        fail(f"a train step launched a kernel: {train_launches}")

    with torch.no_grad():
        for group, params in (("G", g_params), ("D", d_params)):
            moved = sum(int(not torch.equal(p, params0[k])) for k, p in params.items())
            print(f"train: {moved} of {len(params)} {group} parameter tensors moved")
            if moved == 0:
                fail(f"no {group} parameter moved")
        # Unused shortcut convs never advance; the ``u`` of a one-output layer is always 1.
        skip = unused_shortcuts(model)
        stale = [k for k, b in model.named_buffers()
                 if not k.endswith("num_batches_tracked") and b.numel() > 1
                 and not any(k.startswith(s + ".") for s in skip)
                 and torch.equal(b, buffers0[k])]
        tracked = [k for k in buffers0 if not k.endswith("num_batches_tracked")]
        advanced = sum(int(not torch.equal(buffers0[k], model.get_buffer(k))) for k in tracked)
        print(f"train: {advanced} of {len(tracked)} BN/SN buffers advanced "
              f"({len(skip)} unused shortcut convs and the heads' 1-element u keep theirs)")
        if stale:
            fail(f"BN/SN buffers did not advance: {stale[:5]}")

    for counter in launch_counters:
        counter.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    val = training.make_eval_step(model)(state, x, y, torch.Generator().manual_seed(300))
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_launches = {c.__name__: c.launches for c in launch_counters}
    forwards = 2 + model.generation_steps
    expected = {"convgru_rollout": 4 * forwards, "gblock_fused": 8 * forwards}
    print(f"eval step: {json.dumps({k: v.item() for k, v in val.items()})}, "
          f"{eval_s:.4f} s, launches {eval_launches}, expected {expected}")
    if eval_launches != expected:
        fail(f"the eval step's kernel launches {eval_launches} differ from {expected}")
    if not all(math.isfinite(v.item()) for v in val.values()):
        fail(f"eval step: non-finite metrics {val}")

    print(f"train: seconds per step {[round(s, 4) for s in seconds]} (step 1 is the warm-up), "
          f"B=2 at {model.output_shape}^2, {model.forecast_steps} steps, "
          f"generation_steps {model.generation_steps}, on {card}")
    print(f"train split of step {TRAIN_STEPS} (synchronized): D phase {split['d_phase']:.4f} s, "
          f"G phase {split['g_phase']:.4f} s, logging forward {split['logging_forward']:.4f} s")
    print(f"train: peak device memory {peak / 2**30:.3f} GiB (max_memory_allocated) on {card}")

    # One more step without the rollout recompute, for its time and memory.
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = training.make_train_step(model, rollout_remat=False)(
        state, x, y, torch.Generator().manual_seed(400))
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if not all(math.isfinite(v.item()) for v in metrics.values()):
        fail(f"train step without recompute: non-finite metrics {metrics}")
    print(f"train without rollout recompute: {plain_s:.4f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB on {card}")
    return {"train_step": train_launches, "eval_step": eval_launches}


def train_parity(torch, dev) -> None:
    """Phase 8: one tiny train step on the card and on the CPU, same weights and draws, SGD."""
    from skillful_nowcasting_tpu_torch import DGMR, training
    from skillful_nowcasting_tpu_torch.utils import random_fill

    base = random_fill(DGMR(**TINY, device="cpu"), torch.Generator().manual_seed(20))
    training.desaturate_discriminator(base)
    gen = torch.Generator().manual_seed(21)
    x = torch.rand((2, 4, 1, 64, 64), generator=gen)
    y = torch.rand((2, 2, 1, 64, 64), generator=gen)
    draws = training.draw_step(base, 6, torch.Generator().manual_seed(22))

    def one_step(device, dtype):
        model = DGMR(**TINY, device=device)
        model.load_state_dict(base.state_dict())
        model.to(dtype)
        g, d = training.split_params(model)
        state = training.init_train_state(
            model, (torch.optim.SGD(g.values(), lr=5e-5), torch.optim.SGD(d.values(), lr=2e-4)))
        m = training.make_train_step(model, return_grads=True)(
            state, x.to(dtype), y.to(dtype), draws=draws)
        cpu = lambda v: v.detach().to("cpu", torch.float64)  # noqa: E731
        return {
            "losses": {k: cpu(v).reshape(1) for k, v in m.items() if k.startswith("train/")},
            "g grads": {k: cpu(v) for k, v in m["g_grads"].items()},
            "d grads": {k: cpu(v) for k, v in m["d_grads"].items()},
            "params": {k: cpu(p) for k, p in model.named_parameters()},
        }

    def worst(got, want):
        top = max(v.abs().max().item() for v in want.values())
        return max(
            ((got[k] - w).abs().max().item() / max(w.abs().max().item(), 1e-6 * top), k)
            for k, w in want.items()
        )

    cpu_steps = {}
    for dtype in (torch.float64, torch.float32):
        card, cpu_steps[dtype] = one_step(dev, dtype), one_step("cpu", dtype)
        worst_all = max((worst(card[g], cpu_steps[dtype][g]) + (g,)) for g in card)
        print(f"train parity {str(dtype)[6:]} (card vs CPU, one tiny SGD step): worst "
              f"{worst_all[0]:.3e} of the tensor's max-abs at {worst_all[2]} {worst_all[1]}")
        if dtype == torch.float64 and not worst_all[0] <= TRAIN_TOL:
            fail(f"card and CPU train steps differ by {worst_all[0]} > {TRAIN_TOL}")
    # What f32 rounding alone does to one step: the CPU's f32 step against its f64 one.
    f32, f64 = cpu_steps[torch.float32], cpu_steps[torch.float64]
    for group in f64:
        top = worst(f32[group], f64[group])
        print(f"train rounding (CPU float32 vs float64), {group}: worst {top[0]:.3e} at {top[1]}")


def device_tiles(h: int, w: int, tile: int = 256, overlap: int = 64) -> int:
    """Tiles of ``tiled_nowcast_device``: the field padded by overlap/2 a side, whole strides."""
    stride = tile - overlap
    return math.prod(max(0, -(-(n + overlap - tile) // stride)) + 1 for n in (h, w))


def host_tiles(h: int, w: int, tile: int = 256, overlap: int = 64) -> int:
    """Tiles of ``tiled_nowcast``: starts at whole strides, then one flush with the far edge."""
    stride = tile - overlap
    return math.prod(max(0, -(-(n - tile) // stride)) + 1 for n in (h, w))


def launch_counts(counters) -> dict:
    return {c.__name__: c.launches for c in counters}


def counted_forwards(model, counters):
    """Reset the launch counters; record ``model``'s forwards (batch sizes) until removed."""
    for counter in counters:
        counter.launches = 0
    calls = []
    forward = model.forward

    def counting(*args, **kwargs):
        calls.append(args[0].shape[0])
        return forward(*args, **kwargs)

    model.forward = counting
    return calls


def expect_launches(model, counters, calls, forwards: int, what: str) -> dict:
    """Stop counting forwards; fail unless there were ``forwards``, each with 4 / 8 launches."""
    del model.forward
    got = launch_counts(counters)
    want = {"convgru_rollout": 4 * forwards, "gblock_fused": 8 * forwards}
    print(f"{what}: {len(calls)} forwards (batches {calls}), launches {got}, expected {want}")
    if len(calls) != forwards or got != want:
        fail(f"{what}: {len(calls)} forwards and launches {got}; expected {forwards} and {want}")
    return got


def old_style_keys(sd: dict) -> dict:
    """The keys of the old ``torch.nn.utils.spectral_norm``, with the derived ``weight``."""
    import torch

    out = {}
    tail = ".parametrizations.weight.original"
    for k, v in sd.items():
        if k.endswith(tail):
            mod = k[: -len(tail)]
            u = sd[f"{mod}.parametrizations.weight.0._u"]
            vv = sd[f"{mod}.parametrizations.weight.0._v"]
            out[f"{mod}.weight_orig"], out[f"{mod}.weight_u"], out[f"{mod}.weight_v"] = v, u, vv
            out[f"{mod}.weight"] = v / torch.dot(u, v.reshape(v.shape[0], -1) @ vv)
        elif not k.endswith(("._u", "._v")):
            out[k] = v
    return out


def hub_round_trips(torch, dev, model, card, counters) -> dict:
    """Phase 9: save and reload the full-width model three ways; each nowcast bit-identical."""
    import shutil
    from pathlib import Path

    from skillful_nowcasting_tpu_torch import DGMR, models
    from skillful_nowcasting_tpu_torch.hub import compose_generator
    from skillful_nowcasting_tpu_torch.hub import safetensors as st
    from skillful_nowcasting_tpu_torch.hub.pretrained import reference_state_dict

    root = Path(__file__).resolve().parent / "build" / "chip_smoke_hub"
    shutil.rmtree(root, ignore_errors=True)
    x = torch.rand((2, 4, 1, 256, 256), generator=torch.Generator().manual_seed(30)).to(dev)
    z = torch.randn((1, 8, 8, 8), generator=torch.Generator().manual_seed(31)).to(dev)
    calls = counted_forwards(model, counters)
    with torch.inference_mode():
        want = model(x, z=z)

    def check(label, load, nbytes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = load()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        calls.append(x.shape[0])  # the loaded model's forward counts with the source's
        with torch.inference_mode():
            got = loaded(x, z=z)
        err = (got - want).abs().max().item()
        print(f"hub {label}: {nbytes} bytes of weight files loaded in {seconds:.4f} s "
              f"onto {card}; nowcast max_abs_err {err:.3e} against the source model")
        if not torch.equal(got, want):
            fail(f"hub {label}: the loaded model's nowcast differs from the source's by {err}")

    try:
        t0 = time.perf_counter()
        nbytes = model.save_pretrained(str(root / "native"))
        print(f"hub save_pretrained: {nbytes} bytes in {time.perf_counter() - t0:.4f} s")
        check("save_pretrained -> DGMR.from_pretrained",
              lambda: DGMR.from_pretrained(str(root / "native")), nbytes)

        (root / "old_style").mkdir(parents=True)
        shutil.copy(root / "native" / "config.json", root / "old_style" / "config.json")
        nbytes = st.save_file(old_style_keys(reference_state_dict(model)),
                              str(root / "old_style" / "model.safetensors"))
        check("old-style SN keys + generator.* copies -> DGMR.from_pretrained",
              lambda: DGMR.from_pretrained(str(root / "old_style")), nbytes)

        stacks = (("conditioning_stack", models.ContextConditioningStack),
                  ("latent_stack", models.LatentConditioningStack), ("sampler", models.Sampler))
        nbytes = sum(getattr(model, name).save_pretrained(str(root / name)) for name, _ in stacks)
        check("three stacks apart -> compose_generator",
              lambda: compose_generator(*(cls.from_pretrained(str(root / name))
                                          for name, cls in stacks)), nbytes)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"hub": expect_launches(model, counters, calls, 4, "hub nowcasts (source + 3 loaded)")}


def tiled_field(torch, dev, model, card, counters) -> dict:
    """Phase 10: a 1184^2 field through both tilers with one latent, checked tile by tile."""
    import numpy as np

    from skillful_nowcasting_tpu_torch.inference import (
        seam_discontinuity,
        smooth_test_field,
        tiled_nowcast,
        tiled_nowcast_device,
    )

    n, tile, overlap = TILED_FIELD, 256, 64
    frames = smooth_test_field(4, n, n, 1, seed=5)
    z = torch.randn((1, 8, 8, 8), generator=torch.Generator().manual_seed(32))
    out, by_path = {}, {}
    # The device tiler edge-pads by 32: 7 x 7 tiles at padded starts 0, 192, ..., 1152.
    # The host tiler: starts 0, 192, ..., 768 and a flush-right 928: 6 x 6 tiles.
    for name, fn, n_tiles in (("tiled_nowcast_device", tiled_nowcast_device, device_tiles(n, n)),
                              ("tiled_nowcast", tiled_nowcast, host_tiles(n, n))):
        calls = counted_forwards(model, counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = fn(model, frames, tile=tile, overlap=overlap, batch_tiles=TILE_BATCH, z=z)
        seconds = time.perf_counter() - t0
        by_path[name] = expect_launches(model, counters, calls, -(-n_tiles // TILE_BATCH),
                                        f"{name} {n}^2, {n_tiles} tiles")
        if out[name].shape != (model.forecast_steps, 1, n, n) or not np.isfinite(out[name]).all():
            fail(f"{name}: output {out[name].shape}, finite {np.isfinite(out[name]).all()}")
        ratio = seam_discontinuity(out[name], tile=tile, overlap=overlap,
                                   device=name == "tiled_nowcast_device")["ratio"]
        print(f"{name} {n}^2: {seconds:.4f} s on {card}; seam_discontinuity ratio {ratio:.4f}")

    striped = tiled_nowcast_device(model, frames, tile=tile, overlap=overlap,
                                   batch_tiles=TILE_BATCH, z=z, fetch_stripes=3)
    if not np.array_equal(striped, out["tiled_nowcast_device"]):
        fail("tiled_nowcast_device: fetch_stripes=3 differs from fetch_stripes=1")
    print("tiled_nowcast_device: fetch_stripes=3 is bit-identical to 1")

    def direct(y0, x0):
        with torch.inference_mode():
            crop = torch.from_numpy(frames[None, :, :, y0:y0 + tile, x0:x0 + tile]).to(dev)
            return model(crop, z=z.to(dev))[0].cpu().numpy()

    # An interior tile of each tiler against its own forward: the device tiler's tile at
    # padded 192 spans real [160, 416) and writes [192, 384); the host tiler's at 192 writes
    # [224, 416). The two tilers share one tile, the host's flush-right 928 = the device's
    # padded 960: on [960, 1152)^2 both write that tile's pixels.
    d1, d2 = direct(160, 160), direct(192, 192)
    dev_out, host_out = out["tiled_nowcast_device"], out["tiled_nowcast"]
    checks = {
        "tiled_nowcast_device interior tile vs direct forward":
            np.abs(dev_out[:, :, 192:384, 192:384] - d1[:, :, 32:224, 32:224]).max(),
        "tiled_nowcast interior tile vs direct forward":
            np.abs(host_out[:, :, 224:416, 224:416] - d2[:, :, 32:224, 32:224]).max(),
        "the two tilers on their shared tile [960, 1152)^2":
            np.abs(dev_out[:, :, 960:1152, 960:1152] - host_out[:, :, 960:1152, 960:1152]).max(),
    }
    for label, err in checks.items():
        print(f"{label}: max_abs_err {err:.3e}")
        if not err <= KERNEL_TOL:
            fail(f"{label}: {err} > {KERNEL_TOL}")
    inner = np.abs(dev_out - host_out)[:, :, 32:-32, 32:-32].max()
    print(f"the two tilers elsewhere (tiles offset by overlap/2, other forwards): "
          f"max |difference| {inner:.3e}, not gated")
    return {f"{k}_{n}": v for k, v in by_path.items()}


def mrms_field(torch, model, card, counters) -> dict:
    """Phase 11: one MRMS CONUS-size field, 3500x7000, 18 steps, through tiled_nowcast_device."""
    import numpy as np

    from skillful_nowcasting_tpu_torch.inference import tiled_nowcast_device

    h, w = MRMS
    frames = torch.rand((4, 1, h, w), generator=torch.Generator().manual_seed(40)).numpy()
    z = torch.randn((1, 8, 8, 8), generator=torch.Generator().manual_seed(41))
    calls = counted_forwards(model, counters)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = tiled_nowcast_device(model, frames, z=z)  # tile 256, overlap 64, 16 tiles a forward
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n_tiles = device_tiles(h, w)  # 19 x 37 = 703: padded to 3712 x 7168 at stride 192
    launches = expect_launches(model, counters, calls, -(-n_tiles // TILE_BATCH),
                               f"MRMS {h}x{w}, {n_tiles} tiles")
    if out.shape != (model.forecast_steps, 1, h, w) or not np.isfinite(out).all():
        fail(f"MRMS field: output {out.shape}, finite {np.isfinite(out).all()}")
    print(f"MRMS {h}x{w}, 18 steps: {seconds:.4f} s, {n_tiles / seconds:.2f} tiles/s, "
          f"peak device memory {peak / 2**30:.3f} GiB (max_memory_allocated) on {card}")
    return {"mrms_field": launches}


def skill_eval(torch, model, card, counters) -> dict:
    """Phase 12: evaluate_nowcast at full width, S=6, B=2, 2 batches."""
    import math

    from skillful_nowcasting_tpu_torch.inference import evaluate_nowcast

    gen = torch.Generator().manual_seed(50)
    size, steps = model.output_shape, model.forecast_steps
    batches = [(torch.rand((2, 4, 1, size, size), generator=gen),
                10.0 * torch.rand((2, steps, 1, size, size), generator=gen)) for _ in range(2)]
    calls = counted_forwards(model, counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = evaluate_nowcast(model, batches, num_samples=6,
                               generator=torch.Generator().manual_seed(51))
    seconds = time.perf_counter() - t0
    launches = expect_launches(model, counters, calls, 2 * 6, "evaluate_nowcast")
    print(f"evaluate_nowcast (S=6, B=2, 2 batches): {json.dumps(metrics)}, {seconds:.4f} s "
          f"on {card}")
    if not all(math.isfinite(v) for v in metrics.values()) or metrics["batches"] != 2:
        fail(f"evaluate_nowcast: {metrics}")
    return {"skill_eval": launches}


def serving_parity_tiny(torch, dev) -> None:
    """Phase 13: the tiled nowcast and the skill loop, card vs CPU, tiny config, fixed latents."""
    import numpy as np

    from skillful_nowcasting_tpu_torch import DGMR
    from skillful_nowcasting_tpu_torch.inference import evaluate_nowcast, tiled_nowcast_device
    from skillful_nowcasting_tpu_torch.utils import random_fill

    cpu = random_fill(DGMR(**TINY, device="cpu"), torch.Generator().manual_seed(60)).eval()
    card = DGMR(**TINY, device=dev).eval()
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(61)
    frames = rng.random((4, 1, 150, 100), np.float32)
    z = torch.randn((1, 8, 2, 2), generator=torch.Generator().manual_seed(62))
    kw = dict(tile=64, overlap=16, batch_tiles=5, z=z)
    on_card, on_cpu = (tiled_nowcast_device(m, frames, **kw) for m in (card, cpu))
    err = np.abs(on_card - on_cpu).max()
    batches = [(rng.random((2, 4, 1, 64, 64), np.float32),
                rng.random((2, 2, 1, 64, 64), np.float32)) for _ in range(2)]
    skill = {}
    for name, m in (("card", card), ("cpu", cpu)):
        skill[name] = evaluate_nowcast(m, batches, num_samples=2, thresholds=(0.0, 0.1),
                                       pools=(1, 4), generator=torch.Generator().manual_seed(63))
    skill_err = max(abs(skill["card"][k] - skill["cpu"][k]) for k in skill["cpu"])
    print(f"serving parity (card vs CPU, tiny config, fixed latents): tiled_nowcast_device "
          f"max_abs_err {err:.3e}, evaluate_nowcast max |difference| {skill_err:.3e}")
    if not (err <= SLICE_TOL and skill_err <= SLICE_TOL):
        fail(f"card and CPU serving paths differ: {err}, {skill_err} > {SLICE_TOL}")


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

    def compare(name, fn, ref, args, label, reps, work, bucket=None):
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
            f"{100 * bound_ms / ms:.1f}% of bound, {work[0] / 1e9:.2f} GFLOP, "
            f"{work[1] / 1e6:.1f} MB"
        )
        if not err <= KERNEL_TOL:
            fail(f"{name} {label}: kernel differs from its plain version by {err} > {KERNEL_TOL}")
        r = results.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                      "bound_ms": 0.0, "bound_by": bound_by,
                                      "peak": PEAK_NAME, "library_ms": None})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if bucket is not None:
            r = r.setdefault(bucket, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                      "bound_ms": 0.0})
            r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["bound_ms"] += bound_ms

    # The serving request's batch (B=2) and the tile batch of tiled_nowcast_device (B=16 tiles,
    # so N = 16 x 18 GBlock rows): the GRU's split-K plan depends on M = B H W.
    steps = 18
    for batch, reps, bucket in ((2, 20, None), (TILE_BATCH, 5, f"tile_batch_{TILE_BATCH}")):
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
                    f"T={steps} gx={tuple(args[0].shape)}", reps=reps,
                    work=gru_work(t_in, batch, hw, c, steps), bucket=bucket)

        n = steps * batch
        for hw, cin, cout in ((8, 768, 768), (16, 384, 384), (32, 192, 192), (64, 96, 96),
                              (16, 384, 192)):
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
                    f"x={tuple(args[0].shape)} cout={cout}", reps=reps,
                    work=gblock_work(n, hw, cin, cout), bucket=bucket)
            del args
    torch.cuda.empty_cache()

    # 4. The slice at full width through make_generate, from a CPU batch.
    batch = 2
    model = serving_model(torch, dev)
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
    del model, cpu_model, generate
    torch.cuda.empty_cache()

    # 7. Training at full width; 8. training parity, card vs CPU.
    counters = (convgru_rollout, gblock_fused)
    by_path = train_full_width(torch, dev, card, counters)
    train_parity(torch, dev)

    # 9-12. The serving user's paths at full width; 13. their parity, card vs CPU.
    model = serving_model(torch, dev)
    by_path.update(hub_round_trips(torch, dev, model, card, counters))
    by_path.update(tiled_field(torch, dev, model, card, counters))
    by_path.update(mrms_field(torch, model, card, counters))
    by_path.update(skill_eval(torch, model, card, counters))
    del model
    torch.cuda.empty_cache()
    serving_parity_tiny(torch, dev)

    sources = {
        "convgru_rollout": ("skillful_nowcasting_tpu_torch/csrc/gru_rollout.cu",
                            "skillful_nowcasting_tpu/ops/pallas_gru.py:40"),
        "gblock_fused": ("skillful_nowcasting_tpu_torch/csrc/gblock_fused.cu",
                         "skillful_nowcasting_tpu/ops/pallas_gblock.py:66"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **results[name],
         "launches_by_path": {"serve": launches[name],
                              **{path: counts[name] for path, counts in by_path.items()}}}
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
