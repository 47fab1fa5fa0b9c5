#!/usr/bin/env python3
"""Drive the PyTorch port's nowcast, serving, artifact, bf16, training, retraining, data-parallel, scoring, spatially sharded (forward and train) and JAX-checkpoint paths once on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
``python3 chip_smoke.py --profile-step`` only profiles one full-width bf16
train step (``profiling.trace``: the card's busy share, the kernel launches,
the top kernels by device time) and prints no result line.

1. Device: needs CUDA; prints the card's name and power limit; TF32 off.
2. Build: compiles the hand-written kernels from ``skillful_nowcasting_tpu_torch/csrc``
   and prints ptxas's registers, shared memory and spills per kernel, and the
   number of HGMMA (wgmma), UTMALDG (TMA load) and HMMA (mma.sync)
   instructions in each kernel's SASS (``cuobjdump -sass``); every kernel,
   f32 and bf16, must show HGMMA and UTMALDG, no HMMA and no spill.
3. Kernels vs their plain PyTorch versions on the card, at the main paths'
   shapes: a request's batch (B=2) and the tile batch of tiled_nowcast_device
   (B=16 tiles, N=288 GBlock rows), each in f32 and in bf16; max-abs
   difference <= 1e-4 (f32) or <= 2^-7 of max|plain| (bf16: one bf16 ulp of
   the largest output), the same bits on a second call; times from CUDA
   events, beside the bound (the larger of FLOPs at the tensor-core peak,
   3xTF32 for f32 and bf16 for bf16, and bytes at the memory peak). Beside
   each GBlock shape, a conv yardstick: cuDNN's ``F.conv2d`` in the shape's
   dtype (f32 with TF32 off; channels_last) for the block's two 3x3 convs (a
   diagnostic; the port never calls it). The four UpsampleGBlock levels
   (``dgmr::upsample_gblock_fused``, the GBlock kernels' upsampling variant)
   at both batches and in both dtypes, each beside the cuDNN path the eager
   block took (nearest upsample, the two 3x3 convs and the 1x1 shortcut by
   ``F.conv2d``, channels_last). Each f32 kernel's summed time at
   each batch is printed beside its time before the Hopper redesign (the
   ``mma.sync`` kernels, ``PERF.md``).
4. The slice at full width: ``DGMR()`` (on the card by default; 256x256, 18
   steps, latent 768, context 384, 6 samples) with seeded random weights
   answers 3 requests through ``make_generate`` from a CPU batch; the
   kernels' launch counters must rise by the count the path implies (one
   rollout launch per ConvGRU level, two per GBlock and per UpsampleGBlock).
5. End-to-end parity: one B=1 forward with a fixed latent on the card
   (kernels) and on the CPU (plain versions): max-abs <= 1e-3.
6. Where the time goes: one per-sample request under
   ``profiling.record(device=True)``, each span's stream time as a share of
   that request's wall.
7. Training at full width: the paper config with seeded random weights
   (``random_fill`` + ``desaturate_discriminator``), B=2 random context and
   target sequences, ``init_train_state``, 3 ``make_train_step`` steps
   (defaults: logging forward, rollout recompute) and 1 ``make_eval_step``.
   Metrics finite, G and D parameters moved, every BN running statistic and
   every used SN vector advanced, no kernel launch in a train step (train
   mode takes the plain paths, as in JAX), and exactly 4 / 8 launches per
   generator forward in the eval step. Prints seconds per step, a
   synchronized D / G / logging split of steps 2-3 and peak memory; R1's cost
   on an f32 step (two ``r1_gamma=10`` steps on the same state: their D
   phases against steps 2-3's, ``d_r1`` finite and > 0); then
   the time and peak memory of one more step without the rollout recompute.
8. Training parity, card vs CPU, at the CPU tests' tiny config: the same
   weights, the same explicit draws, SGD, one train step each. Losses,
   gradients and post-step parameters agree to max-abs <= 1e-3 of each
   tensor's max-abs (floored at 1e-6 of its group's largest: a conv bias in
   front of a train-mode BatchNorm has a true gradient of 0) in float64,
   without and with the R1 penalty (``r1_gamma=10``); the float32 figure is
   printed beside it.
9. Hub round trips at full width: ``save_pretrained`` then
   ``DGMR.from_pretrained`` onto the card; the same weights with old-style
   spectral-norm keys and ``generator.*`` copies; the three stacks saved
   apart and rejoined by ``compose_generator``; then the same two in the JAX
   package's native format (``config.json`` + ``flax_model.msgpack``, written
   by ``hub.pretrained.save_checkpoint``). Each fixed-latent nowcast is
   bit-identical to the source model's; bytes and seconds printed.
10. A 1184x1184 field through both tilers (tile 256, overlap 64, 16 tiles a
   forward), one latent: 4 / 8 launches per forward, an interior tile of
   each against a direct forward and the tile the two tilers share against
   each other (<= 1e-4), ``fetch_stripes=3`` and the field handed over on the
   card bit-identical to the host field, the seam ratio printed.
11. One MRMS CONUS field, 3500x7000, 18 steps, through
   ``tiled_nowcast_device``: seconds, tiles/s, peak memory. (The same field
   handed over on the card, which gives the same bits, is checked on phase
   10's 1184^2 field rather than this one, to save 18 s of the run.)
12. ``evaluate_nowcast`` at full width, S=6, B=2, 2 batches: finite metrics.
13. ``tiled_nowcast_device`` and ``evaluate_nowcast`` at the tiny config on
   the card and on the CPU, fixed latents: max-abs <= 1e-3.
14. The serving artifact at full width (paper config, B=2, S=6, f32):
   ``serving.save_exported`` then ``load_exported(...).place()``; export,
   save and load seconds and bytes; 3 requests through
   ``NowcastServer.generate`` (72 / 144 launches); the first against
   ``make_generate(model)(x, torch.Generator().manual_seed(seed))`` (max-abs
   <= 1e-6, bit equality printed); a card-resident ``x`` gives the host
   ``x``'s bits; one sampler weight replaced changes the output; a
   ``compute_dtype=torch.bfloat16`` artifact returns finite f32.
15. bf16 at full width: 3 requests of B=2, S=6 from a bf16 batch (frames/s,
   latency, 4 / 8 bf16 launches a forward and no f32 launch); bf16 against
   f32 on fixed latents below 0.15 of scale; one MRMS 3500x7000 field through
   ``tiled_nowcast_device(dtype=torch.bfloat16)``; a bf16 layer breakdown from
   the spans.
16. The retraining path at full width (paper config, seeded weights,
   desaturated D, B=2 synthetic radar rendered on the card): 3 bf16 train
   steps (seconds, the D / G / logging split of steps 2-3, peak memory,
   carried state all f32); R1's cost on a bf16 step as phase 7 measures it
   on f32; the overhead of ``watch_gradients`` + ``watch_histograms`` on a
   bf16 step, after the G update where they run, against steps 2-3
   (histogram counts sum to the parameter count); each cost counts as
   resolved only where its times lie above every time without it; then
   ``Trainer.fit`` (bf16, R1, ``ckpt_every=2``,
   ``val_every=2``, ``val_skill``, ``log_every=1``, ``prefetch=2``) on
   ``synthetic_radar_batches_device``, sent SIGTERM by its train iterator
   after step 3: ``latest/`` holds step 3, the checkpoint restores
   bit-identical (bytes, save and restore seconds printed), and a new
   Trainer resumes it to step 4. The train steps launch no kernel; each
   validation launches 4 / 8 bf16 kernels per generator forward and no f32
   kernel.
17. Data parallelism on one card: the parent (kernels built, its models
   freed) starts two ranks of this script (``--dp-rank``), each its own
   process on ``cuda:0`` over ``gloo`` (NCCL refuses two ranks on one card),
   with a timeout; a rank that fails fails the phase. (a) Tiny config,
   float64, SGD, explicit draws: both DP modes on the 2 card ranks against
   the same on 2 CPU ranks (the same processes), and ``pjit`` on 2 x B=1
   against the plain step at B=2 on the card, each <= 1e-3 of a tensor
   (phase 8's floor). (b) Full width: ``Trainer.fit(mesh, dp_mode="shard_map")``
   in bf16 with R1, B=2 a rank, ``val_every=2``, ``ckpt_every=2``, SIGTERM
   to rank 1 after step 2 (both ranks stop there), then new Trainers resume
   to step 3: a gathered checksum of every parameter and buffer equal on
   both ranks after every step, checkpoints written by rank 0 only and
   holding both ranks' generator states, every rank restoring, validation
   4 / 8 bf16 launches a forward on each rank; per rank the seconds per
   step, the gradient all-reduces' bytes and seconds and the peak memory
   (two ranks share the SMs and gloo stages through the host: no scaling
   figure). (c) Phase 10's 1184^2 field through ``tiled_nowcast_device(mesh=)``
   and ``tiled_nowcast(mesh=)`` at 8 tiles a forward (two ranks' f32 tile
   batches share the card's memory), each bit-identical to one rank's run
   with the same forwards and 4 / 8 launches a forward on each rank;
   ``make_dp_generate`` against ``make_generate`` on the same latents;
   ``halo_conv2d`` on CUDA tensors against the dense conv. (d) NCCL, a world
   of one from a launcher's environment: one all-reduce of a buffer the size
   of the model's gradients and a train step on the mesh of one. Then a
   diagnostic: whether gloo's point-to-point calls take CUDA tensors.
18. Scoring a full-width nowcast: phase 4's ``DGMR()`` answers one request
   of B=2 seeded advecting-blob context frames (over 12: fields of about
   [0, 1]) through ``make_generate`` (4 / 8 launches a forward), and every
   ported loss scores the S=6 ensemble against the batch's 18 target frames:
   every ``get_loss`` name, ``ssim`` / ``ms_ssim`` over the 216 nowcast
   frames (5 levels), ``SSIMLossDynamic`` against the last context frame,
   ``grid_cell_regularizer`` over the samples, ``GridCellLoss`` of the
   ensemble mean, ``FocalLoss`` and the NLL names on a seeded rain
   probability against the target's rain (> 1 mm/h). Each loss on the card
   equals the same loss of the same tensors on the CPU to <= 1e-5 relative.
   The gradients of ``MS_SSIMLoss`` and ``SSIMLoss`` w.r.t. the 216 frames,
   card vs CPU, <= 1e-4 of max-abs, with the seconds and peak memory of each
   forward + backward. ``CoordConv`` (both ``with_r``, f32 and bf16, eval
   and one train forward) card vs CPU (<= 1e-5, bf16 <= 2^-7 of max|out|),
   SN ``u`` / ``v`` advanced by exactly one power iteration in train mode;
   ``DGMR(conv_type="coord")`` raises ``TypeError``.
19. The generator forward H-sharded over a ``(data=1, space=2)`` mesh
   (``parallel.make_spatial_forward``). (a) In the parent, before the ranks:
   each kernel, f32 and bf16, alone on the windows that layout hands it at
   512^2 (GBlock 10 / 18 / 34 / 66 rows at widths 16-128, the rollout 101 x
   128 at the top level and whole levels below), against its plain version
   at phase 3's tolerances, timed beside its bound. Then two ranks of this
   script on ``cuda:0`` over ``gloo``, as in phase 17, each with phase 4's
   seeded weights in ``DGMR(output_shape=512)``, B=1 seeded advecting-blob
   context frames and a fixed latent: (b) the gathered sharded nowcast
   against the dense forward of the same model on the rank, f32 (TF32 off)
   <= 1e-4 of max|dense| and bf16 <= 2^-5 of each frame's max|dense| (four
   bf16 ulps; the dense forward's own spread, the same sample at B=2
   against B=1, is two, printed beside it with the one-ulp verdict), with
   the share of bit-equal elements; (c) exactly 4 / 8 launches of the
   input's dtype in a sharded forward, the kernels' window rows as the
   layout implies, ``halo_window`` called; (d) seconds of a forward after a
   warm-up and peak memory, sharded and dense, the halo calls, bytes and
   host seconds of a forward (gloo stages them through the host) and the
   rollout's recompute factor per level (window rows / stripe rows); (e) the
   same in bf16 at 1024^2. Two ranks on one card measure the semantics and
   the layout's costs, not scaling. A diagnostic on rank 0 at 512^2 bf16:
   the first modules whose dense output for the sample alone (B=1) parts
   from the same sample's in a B=2 batch, in the order the modules finish.
20. The H-sharded train and eval steps (``make_dp_train_step`` /
   ``make_dp_eval_step(mode="pjit", spatial_axis="space")``) on a ``(data=1,
   space=2)`` mesh. (a) The tiny config, float64, R1, explicit draws: the
   plain step on the card here, then two ranks of this script on ``cuda:0``
   (``gloo``) run the step on their stripes on the card and on the CPU: card
   ranks against CPU ranks and against the plain step, <= 1e-3 of each
   tensor (phase 8's floor). (b) In the same ranks, the paper config at
   256^2, B=2, seeded weights, desaturated D: one f32 SGD step (TF32 off)
   against rank 0's dense step on the same draws (the six ``train/*`` <=
   1e-3 relative, the first D update's gradients <= 1e-3 of each tensor, the
   G gradients' gap printed beside phase 8's f32 rounding), one bf16 step
   with R1 (finite; every parameter and buffer bit-identical on both ranks,
   by a gathered checksum; no kernel launched, as in every train step), one
   f32 eval step (<= 1e-4 relative of the dense one; 4 / 8 launches a
   generator forward, on windows); per rank the seconds of each, its peak
   memory above what was allocated before it, and the halo calls, bytes and
   host seconds, forward and backward apart. (c) In the same ranks,
   ``Trainer(mesh, dp_mode="pjit", spatial_axis="space")`` at the tiny
   config in f32: two steps on card-rendered synthetic radar, the validation
   at step 2 with ``val_skill`` (4 / 8 launches a forward of its eval step
   and skill ensemble, on windows; finite logged metrics). Two ranks on one
   card, again: semantics and costs, not scaling.

21. The JAX package's Orbax checkpoint at full width: phase 7's paper config
   in f32 takes one train step, ``checkpoint.save_jax_state`` writes it
   (bytes, seconds), a fresh state on the card restores it (read + decode,
   then convert + copy, seconds apart); every parameter, buffer, Adam moment
   and step, scheduler count and ``state.step`` must be ``torch.equal`` to
   the source's; the eval step of both, through both f32 kernels, must be
   equal with 32 / 64 launches; the next train step of both, with the same
   draws and ``cudnn.deterministic``, must give equal metrics and
   parameters; a ``Trainer`` on the directory must print "resumed from step
   1" and take one step, writing its own ``state.pt``.

Every path's launches are counted from 0 and must be 4 (rollout) and 8
(GBlock) per generator forward, all of the path's dtype. Any failure exits
non-zero without the final line. The last two lines are a JSON object of
per-kernel results (f32 and bf16 variants of both kernels) and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

KERNEL_TOL = 1e-4
KERNEL_TOL_BF16 = 2.0**-7  # of max|plain|: one bf16 ulp of the largest output
BF16_TOL = 0.15  # bf16 vs f32 nowcast, of max(max|f32|, 1e-3): the JAX suite's bar
ARTIFACT_TOL = 1e-6
SLICE_TOL = 1e-3
TRAIN_TOL = 1e-3
REQUESTS = 3
TILE_BATCH = 16  # tiles per forward of tiled_nowcast_device (its default)
TILED_FIELD = 1184  # = 256 + 5 * 192 - 32: the host tiler's flush-right tile is a device tile
MRMS = (3500, 7000)  # MRMS CONUS grid
TRAIN_STEPS = 3
R1_GAMMA = 10.0
TINY = dict(forecast_steps=2, output_shape=64, latent_channels=256, context_channels=32,
            generation_steps=2, num_spatial_layers=2, num_temporal_layers=2)
# Published H100 SXM peaks (dense). 3xTF32 does three TF32 products per f32 product.
PEAK_3XTF32 = 495e12 / 3
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
PEAK_NAME = {"f32": "3xTF32 tensor cores, 495/3 TFLOP/s; HBM 3.35 TB/s",
             "bf16": "bf16 tensor cores, 989 TFLOP/s; HBM 3.35 TB/s"}


class Counter:
    """One kernel variant's launch count: an attribute of its wrapper, raised per launch."""

    def __init__(self, fn, attr: str, name: str):
        self.fn, self.attr, self.__name__ = fn, attr, name

    @property
    def launches(self) -> int:
        return getattr(self.fn, self.attr)

    @launches.setter
    def launches(self, value: int) -> None:
        setattr(self.fn, self.attr, value)


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


def bound(flops: float, nbytes: float, kind: str = "f32") -> tuple[float, float]:
    """Least milliseconds for the work by operations and by bytes, at the card's peaks.

    The bound is the larger of the two; f32 products run as 3xTF32, bf16 ones
    at the bf16 tensor-core rate.
    """
    peak = PEAK_3XTF32 if kind == "f32" else PEAK_BF16
    return 1e3 * flops / peak, 1e3 * nbytes / PEAK_BYTES


def gru_work(t_in: int, b: int, hw, c: int, steps: int, elem: int = 4):
    """FLOPs and bytes of one rollout: 18 steps of conv3(h, k_ru) and conv3(r*h, k_c).

    ``hw`` is the side of a square map or its ``(h, w)``. Every operand has
    ``elem`` bytes an element (4 f32, 2 bf16).
    """
    m = b * math.prod((hw, hw) if isinstance(hw, int) else hw)
    flops = steps * 2.0 * m * 9 * c * 3 * c
    values = 9 * c * 3 * c + 3 * c + t_in * m * 3 * c + m * c + steps * m * c
    return flops, elem * values


def gblock_work(n: int, hw, cin: int, cout: int, elem: int = 4):
    """FLOPs and bytes of one eval GBlock: two 3x3 convs (+ the 1x1 shortcut).

    ``hw`` as in :func:`gru_work`. x, out and the kernels have ``elem`` bytes
    an element; the affines are f32.
    """
    m = n * math.prod((hw, hw) if isinstance(hw, int) else hw)
    sc = cin != cout
    flops = 2.0 * m * 9 * cin * (cin + cout) + (2.0 * m * cin * cout if sc else 0.0)
    values = m * (cin + cout) + 9 * cin * (cin + cout) + (cin * cout if sc else 0)
    return flops, elem * values + 4.0 * (4 * cin + cout)


def upsample_gblock_work(n: int, hw: int, cin: int, cout: int, elem: int = 4):
    """FLOPs and bytes of one eval UpsampleGBlock on an ``hw`` x ``hw`` input.

    The GBlock's work with the 1x1 shortcut at the output's side ``2 hw``,
    but x is read at its own size.
    """
    m = n * (2 * hw) ** 2
    flops = 2.0 * m * (9 * cin * (cin + cout) + cin * cout)
    values = n * hw * hw * cin + m * cout + 9 * cin * (cin + cout) + cin * cout
    return flops, elem * values + 4.0 * (4 * cin + cout)


KERNEL_FUNCTIONS = ("gru_rollout_kernel", "gblock_conv1_kernel", "gblock_conv2_kernel",
                    "gru_rollout_bf16_kernel", "gblock_conv1_bf16_kernel",
                    "gblock_conv2_bf16_kernel", "upsample_gblock_a_f32_kernel",
                    "upsample_gblock_b_f32_kernel", "upsample_gblock_a_bf16_kernel",
                    "upsample_gblock_b_bf16_kernel")
SASS_OPS = ("HGMMA", "UTMALDG", "HMMA")  # wgmma, TMA load, mma.sync
# The f32 kernels' summed phase-3 times before their Hopper redesign (3xTF32 mma.sync fed by
# cp.async; PERF.md section 6, the largest of the runs of that design), ms, by bucket.
F32_BEFORE_MS = {("convgru_rollout", "batch_2"): 3.08, ("gblock_fused", "batch_2"): 5.91,
                 ("convgru_rollout", f"tile_batch_{TILE_BATCH}"): 16.23,
                 ("gblock_fused", f"tile_batch_{TILE_BATCH}"): 40.96,
                 ("convgru_rollout", "space_windows_512"): 4.65,
                 ("gblock_fused", "space_windows_512"): 5.74}


def f32_against_before(results: dict, buckets) -> None:
    """Each f32 kernel's summed time in ``buckets`` beside its time before the Hopper redesign."""
    for (name, bucket), before in F32_BEFORE_MS.items():
        r = results.get(name, {})
        r = r if bucket == "batch_2" else r.get(bucket)
        if bucket in buckets and r:
            print(f"{name} {bucket}: {r['ms']:.4f} ms summed over its shapes, bound "
                  f"{r['bound_ms']:.4f} ms ({100 * r['bound_ms'] / r['ms']:.1f}% of bound); "
                  f"before the Hopper redesign (mma.sync, PERF.md) {before} ms: "
                  f"{'faster' if r['ms'] < before else 'NOT faster'}")


def kernel_label(mangled: str) -> str | None:
    """``name<template argument>`` of one of the port's kernels from its mangled symbol."""
    import re

    for name in KERNEL_FUNCTIONS:
        if re.search(rf"\d{name}I", mangled):
            return f"{name}<{','.join(re.findall(r'Li(\d+)E', mangled))}>"
    return None


def sass_counts(_build) -> dict:
    """HGMMA (wgmma), UTMALDG (TMA load) and HMMA (mma.sync) instructions per kernel's SASS."""
    from pathlib import Path

    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.build())], capture_output=True,
                          text=True, check=True).stdout
    counts, label = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            label = kernel_label(line.split("Function : ", 1)[1].strip())
            if label is not None:
                counts[label] = dict.fromkeys(SASS_OPS, 0)
        elif label is not None:
            for op in SASS_OPS:
                counts[label][op] += f" {op}" in line
    return counts


def spills(report: str) -> dict:
    """Spill bytes (stores + loads) per kernel from ptxas's report."""
    import re

    out, label = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            label = kernel_label(line.split("'")[1])
        elif label is not None and "spill stores" in line:
            stores, loads = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                      line).groups()
            out[label] = int(stores) + int(loads)
    return out


def serving_model(torch, dev, **config):
    """The paper-config ``DGMR(**config)`` on the card: seeded weights, BN stats and gamma perturbed.

    ``config`` may change ``output_shape`` (the latent's size), which no weight depends on.
    """
    from skillful_nowcasting_tpu_torch import DGMR
    from skillful_nowcasting_tpu_torch.utils import random_fill

    model = DGMR(**config).eval()
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


def layer_times(torch, model, x, card: str, tag: str = "") -> None:
    """One per-sample request under ``profiling.record(device=True)``: each span's stream time.

    Per span name, the count and the stream milliseconds summed (a
    ``dgmr.derive.sn`` inside a ``dgmr.derive.gblock`` or ``.rollout`` counts
    in both; ``dgmr.derive.*`` sums the outermost derivations), each as a share
    of the request's wall.
    """
    from skillful_nowcasting_tpu_torch import profiling
    from skillful_nowcasting_tpu_torch.inference import make_generate

    generate = make_generate(model)
    generate(x, torch.Generator().manual_seed(7))  # warm-up
    torch.cuda.synchronize()
    with profiling.record(device=True) as log:
        t0 = time.perf_counter()
        generate(x, torch.Generator().manual_seed(8))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = log.spans()
    by_id = {s["id"]: s for s in spans}
    totals: dict[str, tuple] = {}
    for s in spans:
        if s["stream_ms"] is None:  # a host-only span (dgmr.generate)
            continue
        names = [s["name"]]
        parent = by_id.get(s["parent"])
        while parent is not None and not parent["name"].startswith("dgmr.derive."):
            parent = by_id.get(parent["parent"])
        if s["name"].startswith("dgmr.derive.") and parent is None:
            names.append("dgmr.derive.*")
        for name in names:
            count, ms = totals.get(name, (0, 0.0))
            totals[name] = (count + 1, ms + s["stream_ms"])
    for name, (count, ms) in sorted(totals.items()):
        print(f"layer{tag} {name}: {count} spans, {ms:.3f} stream ms, "
              f"{100 * ms / (1e3 * wall):.1f}% of the wall")
    print(f"layer{tag} wall: {1e3 * wall:.3f} ms ({x.dtype}) on {card}")


def split_step(torch, training, step, state, x, y, draw) -> dict:
    """Run one train step with a synchronize after each optimizer update; seconds per phase.

    The step applies D, D, then G updates; the logging forward (and the watch
    flags' histograms and norms) follows. Returns the seconds and the metrics.
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
        metrics = step(state, x, y, draw)
        torch.cuda.synchronize()
    finally:
        training._apply = apply
    end = time.perf_counter()
    return {"d_phase": marks[1] - t0, "g_phase": marks[2] - marks[1],
            "logging_forward": end - marks[2], "step": end - t0, "metrics": metrics}


def r1_cost(torch, training, model, state, x, y, dtype, plain: list, card: str) -> None:
    """R1's cost on a step: the D phases of 2 split R1 steps against those of ``plain`` splits.

    R1 adds work to the D phase only, so the D phases are compared. The cost
    counts as resolved only where the two sets of D phases do not overlap.
    """
    name = "f32" if dtype is None else "bf16"
    step_r1 = training.make_train_step(model, compute_dtype=dtype, r1_gamma=R1_GAMMA)
    runs = [split_step(torch, training, step_r1, state, x, y, torch.Generator().manual_seed(seed))
            for seed in (510, 511)]
    for run in runs:
        metrics = run["metrics"]
        d_r1 = metrics["train/d_r1"].item()
        if not (math.isfinite(d_r1) and d_r1 > 0) or not all(
                math.isfinite(v.item()) for v in metrics.values()):
            fail(f"{name} R1 step: d_r1 {d_r1}, metrics {metrics}")
    d_with = [r["d_phase"] for r in runs]
    d_plain = [r["d_phase"] for r in plain]
    cost = sum(d_with) / len(d_with) - sum(d_plain) / len(d_plain)
    verdict = "resolved" if min(d_with) > max(d_plain) else "unresolved: the D phases overlap"
    print(f"retrain R1 {name} (r1_gamma={R1_GAMMA}): D phase {[round(d, 4) for d in d_with]} s "
          f"with, {[round(d, 4) for d in d_plain]} s without; R1 costs {cost:.4f} s a step "
          f"({verdict}); whole steps {[round(r['step'], 4) for r in runs]} s with, "
          f"{[round(r['step'], 4) for r in plain]} s without; d_r1 {d_r1:.6e}; on {card}")


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
    seconds, splits = [], []
    for i in range(TRAIN_STEPS):
        draw = torch.Generator().manual_seed(200 + i)
        if i:  # every step after the warm-up, split into its phases
            splits.append(split_step(torch, training, step, state, x, y, draw))
            metrics = splits[-1]["metrics"]
            seconds.append(splits[-1]["step"])
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
    split = splits[-1]
    peak = torch.cuda.max_memory_allocated()
    # R1's cost on an f32 step, on the same state (phase 16 does the same for bf16).
    r1_cost(torch, training, model, state, x, y, None, splits, card)
    train_launches = {c.__name__: c.launches for c in launch_counters}
    print(f"train launches over {TRAIN_STEPS} steps and 2 R1 steps: {train_launches} "
          f"(expected 0 each)")
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
    expected = expected_launches(forwards)
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


def train_parity(torch, dev) -> dict:
    """Phase 8: one tiny train step on the card and on the CPU, same weights and draws, SGD."""
    from skillful_nowcasting_tpu_torch import DGMR, training
    from skillful_nowcasting_tpu_torch.utils import random_fill

    base = random_fill(DGMR(**TINY, device="cpu"), torch.Generator().manual_seed(20))
    training.desaturate_discriminator(base)
    gen = torch.Generator().manual_seed(21)
    x = torch.rand((2, 4, 1, 64, 64), generator=gen)
    y = torch.rand((2, 2, 1, 64, 64), generator=gen)
    draws = training.draw_step(base, 6, torch.Generator().manual_seed(22))

    def one_step(device, dtype, r1_gamma=0.0):
        model = DGMR(**TINY, device=device)
        model.load_state_dict(base.state_dict())
        model.to(dtype)
        g, d = training.split_params(model)
        state = training.init_train_state(
            model, (torch.optim.SGD(g.values(), lr=5e-5), torch.optim.SGD(d.values(), lr=2e-4)))
        m = training.make_train_step(model, return_grads=True, r1_gamma=r1_gamma)(
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
    # The R1 penalty (a D forward and a double backward per D update), float64.
    card, cpu = one_step(dev, torch.float64, R1_GAMMA), one_step("cpu", torch.float64, R1_GAMMA)
    worst_all = max((worst(card[g], cpu[g]) + (g,)) for g in card)
    print(f"train parity r1_gamma={R1_GAMMA} float64 (card vs CPU, one tiny SGD step): d_r1 "
          f"{cpu['losses']['train/d_r1'].item():.6e}, worst {worst_all[0]:.3e} of the tensor's "
          f"max-abs at {worst_all[2]} {worst_all[1]}")
    if not worst_all[0] <= TRAIN_TOL:
        fail(f"card and CPU R1 train steps differ by {worst_all[0]} > {TRAIN_TOL}")
    # What f32 rounding alone does to one step: the CPU's f32 step against its f64 one.
    f32, f64 = cpu_steps[torch.float32], cpu_steps[torch.float64]
    rounding = {}
    for group in f64:
        top = worst(f32[group], f64[group])
        rounding[group] = top[0]
        print(f"train rounding (CPU float32 vs float64), {group}: worst {top[0]:.3e} at {top[1]}")
    return rounding


def carried_state_is_f32(torch, state) -> bool:
    """Parameters, BN/SN buffers and the Adam moments of a train state are all float32."""
    moments = [v for opt in (state.g_opt, state.d_opt) for st in opt.state.values()
               for v in st.values() if v.ndim]
    tensors = [*state.model.parameters(), *moments,
               *(b for k, b in state.model.named_buffers() if not k.endswith("num_batches_tracked"))]
    return all(t.dtype == torch.float32 for t in tensors)


def timed_step(torch, step, state, x, y, seed) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = step(state, x, y, torch.Generator().manual_seed(seed))
    torch.cuda.synchronize()
    return time.perf_counter() - t0, metrics


def profile_step(torch, card) -> None:
    """``--profile-step``: one full-width bf16 train step under ``profiling.trace``, after a warm-up.

    Prints the step's wall, the card's busy time in it (the sum of its
    kernels' device time), the kernel launches and the top kernels by device
    time. The profile's processing takes minutes, so the default run skips it.
    """
    from torch.autograd import DeviceType

    from skillful_nowcasting_tpu_torch import DGMR, profiling, training
    from skillful_nowcasting_tpu_torch.data import synthetic_radar_batches_device
    from skillful_nowcasting_tpu_torch.utils import random_fill

    model = training.desaturate_discriminator(
        random_fill(DGMR(), torch.Generator().manual_seed(30)))
    x, y = next(synthetic_radar_batches_device(batch_size=2, seed=31))
    state = training.init_train_state(model)
    step = training.make_train_step(model, compute_dtype=torch.bfloat16)
    for seed in (500, 501):  # warm-up
        timed_step(torch, step, state, x, y, seed)
    root = tempfile.mkdtemp(prefix="dgmr_trace_")
    try:
        t0 = time.perf_counter()
        with profiling.trace(root) as prof:
            sec, _ = timed_step(torch, step, state, x, y, 505)
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        self_ms = lambda e: getattr(e, "self_device_time_total", 0) / 1e3  # noqa: E731
        busy = sum(self_ms(e) for e in kernels)
        kernels.sort(key=self_ms, reverse=True)
        top = "; ".join(f"{e.key[:60]} x{e.count} {self_ms(e):.1f} ms" for e in kernels[:6])
        if busy <= 0:
            fail("the profiler saw no device time in a train step")
        launches = sum(e.count for e in kernels)
        wall = 1e3 * sec
        print(f"retrain bf16 profile (one step under profiling.trace): device busy {busy:.1f} ms "
              f"of {wall:.1f} ms wall ({100 * (1 - busy / wall):.1f}% idle; the whole profile "
              f"with its trace {time.perf_counter() - t0:.1f} s); {launches} kernel launches of "
              f"{len(kernels)} kinds; top device time: {top}; on {card}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def retrain_full_width(torch, dev, card, counters) -> dict:
    """Phase 16: the retraining path at full width (paper config, seeded weights, B=2)."""
    from skillful_nowcasting_tpu_torch import DGMR, checkpoint, training
    from skillful_nowcasting_tpu_torch.data import synthetic_radar_batches_device
    from skillful_nowcasting_tpu_torch.trainer import Trainer
    from skillful_nowcasting_tpu_torch.utils import random_fill

    bf16 = torch.bfloat16

    def fresh_model(seed):
        return training.desaturate_discriminator(
            random_fill(DGMR(), torch.Generator().manual_seed(seed)))

    model = fresh_model(30)
    x, y = next(synthetic_radar_batches_device(batch_size=2, seed=31))
    state = training.init_train_state(model)
    for counter in counters:
        counter.launches = 0

    # bf16 train steps: seconds, the D / G / logging split of each after the warm-up, peak memory.
    step_bf16 = training.make_train_step(model, compute_dtype=bf16)
    torch.cuda.reset_peak_memory_stats()
    seconds, splits = [], []
    for i in range(TRAIN_STEPS):
        draw = torch.Generator().manual_seed(500 + i)
        if i:
            splits.append(split_step(torch, training, step_bf16, state, x, y, draw))
            metrics = splits[-1]["metrics"]
            seconds.append(splits[-1]["step"])
        else:
            sec, metrics = timed_step(torch, step_bf16, state, x, y, 500)
            seconds.append(sec)
    peak = torch.cuda.max_memory_allocated()
    values = {k: v.item() for k, v in metrics.items()}
    print(f"retrain bf16 step {TRAIN_STEPS}: {json.dumps(values)}")
    if not all(math.isfinite(v) for v in values.values()) or any(
            v.dtype != torch.float32 for v in metrics.values()):
        fail(f"bf16 train step: metrics not f32 and finite: {metrics}")
    if not carried_state_is_f32(torch, state):
        fail("bf16 train steps: the carried state is not all float32")
    phases = {k: [round(sp[k], 4) for sp in splits] for k in ("d_phase", "g_phase",
                                                              "logging_forward")}
    print(f"retrain bf16: seconds per step {[round(s, 4) for s in seconds]} (step 1 is the "
          f"warm-up); split of steps 2-{TRAIN_STEPS} (synchronized): D phase {phases['d_phase']} s, "
          f"G phase {phases['g_phase']} s, logging forward {phases['logging_forward']} s; "
          f"peak device memory {peak / 2**30:.3f} GiB; carried state float32; on {card}")

    # R1's cost on a bf16 step (phase 7 measures it on an f32 step).
    r1_cost(torch, training, model, state, x, y, bf16, splits, card)

    # The watch flags' overhead on a bf16 step; the histograms count every parameter.
    step_watch = training.make_train_step(model, compute_dtype=bf16, watch_gradients=True,
                                          watch_histograms=True)
    watch = split_step(torch, training, step_watch, state, x, y,
                       torch.Generator().manual_seed(530))
    metrics = watch["metrics"]
    hists = metrics.pop("train/hist")
    total = sum(p.numel() for p in model.parameters())
    counted = {group: sum(int(h["counts"].sum()) for k, h in hists.items() if k.startswith(group))
               for group in ("train/hist/params/", "train/hist/grads/")}
    norms = sum(k.startswith("train/grad_norm/") for k in metrics)
    # The norms and histograms are computed after the G update, with the logging forward.
    tail = [sp["logging_forward"] for sp in splits]
    extra = watch["logging_forward"] - sum(tail) / len(tail)
    verdict = "resolved" if watch["logging_forward"] > max(tail) else "unresolved: within those"
    print(f"retrain watch (bf16, watch_gradients + watch_histograms, first call): after the G "
          f"update {watch['logging_forward']:.4f} s against {[round(t, 4) for t in tail]} s "
          f"without, overhead {extra:.4f} s ({verdict}); whole step {watch['step']:.4f} s; "
          f"{norms} grad norms, {len(hists)} histograms, counts {counted} of {total} "
          f"parameters; on {card}")
    if set(counted.values()) != {total} or not norms:
        fail(f"watch step: histogram counts {counted} != {total} parameters, or no grad norm")
    train_launches = launch_counts(counters)
    print(f"retrain train steps: launches {train_launches} (expected 0 each)")
    if any(train_launches.values()):
        fail(f"a train step launched a kernel: {train_launches}")
    del model, state, step_bf16, step_watch, splits, watch, metrics, hists
    torch.cuda.empty_cache()

    # Trainer.fit, killed by SIGTERM after step 3, resumed by a new Trainer to step 4.
    root = tempfile.mkdtemp(prefix="dgmr_retrain_")
    try:
        def make_trainer(mdl, max_steps):
            return Trainer(
                mdl, max_steps=max_steps, ckpt_dir=f"{root}/ckpt", log_dir=f"{root}/log",
                compute_dtype=bf16, r1_gamma=R1_GAMMA, ckpt_every=2,
                val_every=2, val_skill=True, log_every=1, prefetch=2, seed=40)

        trainer = make_trainer(fresh_model(41), 10)
        step3 = threading.Event()
        log_scalars = trainer.logger.log_scalars

        def log(scalars, step):
            log_scalars(scalars, step)
            if step == 3 and "train/g_loss" in scalars:
                step3.set()

        trainer.logger.log_scalars = log
        saves = []
        save = trainer._save

        def timed_save(*args):
            t0 = time.perf_counter()
            save(*args)
            saves.append(time.perf_counter() - t0)

        trainer._save = timed_save

        def killed_after_step_3():
            for i, batch in enumerate(synthetic_radar_batches_device(batch_size=2, seed=42)):
                if i == 4:  # step 4's batch (batch 0 is drawn before the loop)
                    if not step3.wait(timeout=900):
                        raise RuntimeError("step 3 was never logged")
                    if signal.getsignal(signal.SIGTERM) != trainer._sigterm:
                        raise RuntimeError("the Trainer's SIGTERM handler is not installed")
                    os.kill(os.getpid(), signal.SIGTERM)
                yield batch

        for counter in counters:
            counter.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        killed = trainer.fit(killed_after_step_3(),
                             synthetic_radar_batches_device(batch_size=2, seed=43))
        fit_s = time.perf_counter() - t0
        fit_peak = torch.cuda.max_memory_allocated()
        trainer_launches = launch_counts(counters)
        forwards = 2 + killed.model.generation_steps + killed.model.num_samples
        expected = expected_launches(forwards, bf16=True)
        print(f"retrain Trainer.fit (bf16, r1_gamma={R1_GAMMA}, prefetch 2, val_skill): "
              f"stopped by SIGTERM at step {killed.step} in {fit_s:.4f} s, peak device memory "
              f"{fit_peak / 2**30:.3f} GiB; validation at step 2: {forwards} generator forwards, "
              f"launches {trainer_launches}, expected {expected}; on {card}")
        if trainer_launches != expected:
            fail(f"the Trainer's validation launches {trainer_launches} differ from {expected}")
        latest = checkpoint.make_manager(f"{root}/ckpt/latest")
        if killed.step != 3 or latest.latest_step() != 3 or latest.all_steps() != [2, 3]:
            fail(f"SIGTERM after step 3: state.step {killed.step}, latest/ {latest.all_steps()}")
        nbytes = os.path.getsize(os.path.join(latest.directory, "3", checkpoint.STATE_FILE))
        params = sum(p.numel() * 4 for p in killed.model.parameters())

        resumed_model = fresh_model(44)
        probe = training.init_train_state(resumed_model)
        t0 = time.perf_counter()
        checkpoint.restore_state(latest, probe, torch.Generator())
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        same = all(torch.equal(a, b) for a, b in zip(killed.model.state_dict().values(),
                                                    resumed_model.state_dict().values()))
        for opt_a, opt_b in ((killed.g_opt, probe.g_opt), (killed.d_opt, probe.d_opt)):
            for st_a, st_b in zip(opt_a.state_dict()["state"].values(),
                                  opt_b.state_dict()["state"].values()):
                same &= all(torch.equal(st_a[k], st_b[k]) for k in st_a)
        print(f"retrain checkpoint: {nbytes} bytes a step ({nbytes / params:.3f} x the f32 "
              f"parameter bytes {params}); saves (latest/ + best/) {[round(s, 4) for s in saves]} "
              f"s; restore {restore_s:.4f} s; restored state bit-identical: {same}; on {card}")
        if not same or probe.step != 3:
            fail("the restored state differs from the state saved at SIGTERM")
        del killed, probe, trainer
        torch.cuda.empty_cache()

        for counter in counters:
            counter.launches = 0
        resumed = make_trainer(resumed_model, 4)
        t0 = time.perf_counter()
        state = resumed.fit(synthetic_radar_batches_device(batch_size=2, seed=45),
                            synthetic_radar_batches_device(batch_size=2, seed=46))
        resumed_launches = launch_counts(counters)
        print(f"retrain resumed: a new Trainer took the run from step 3 to {state.step} in "
              f"{time.perf_counter() - t0:.4f} s; latest/ {latest.all_steps()}; validation "
              f"launches {resumed_launches}")
        if state.step != 4 or latest.latest_step() != 4 or resumed_launches != expected:
            fail(f"resume: step {state.step}, latest/ {latest.all_steps()}, launches "
                 f"{resumed_launches} (expected {expected})")
        if not carried_state_is_f32(torch, state):
            fail("resumed bf16 run: the carried state is not all float32")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"trainer_validation_bf16": trainer_launches}


def _leaves(node) -> list:
    """The leaves of nested dicts and lists (an Orbax tree), ``None`` (an empty node) left out."""
    if isinstance(node, dict):
        return [a for v in node.values() for a in _leaves(v)]
    if isinstance(node, list):
        return [a for v in node for a in _leaves(v)]
    return [] if node is None else [node]


def orbax_full_width(torch, card, counters) -> dict:
    """Phase 21: the JAX package's Orbax format at full width, written, restored and resumed."""
    import contextlib
    import io

    from skillful_nowcasting_tpu_torch import DGMR, checkpoint, training
    from skillful_nowcasting_tpu_torch.ckpt_format import tree as orbax_tree
    from skillful_nowcasting_tpu_torch.data import synthetic_radar_batches_device
    from skillful_nowcasting_tpu_torch.trainer import Trainer
    from skillful_nowcasting_tpu_torch.utils import random_fill

    def fresh_model(seed):
        return training.desaturate_discriminator(
            random_fill(DGMR(), torch.Generator().manual_seed(seed)))

    # Phase 7's paper config in f32: one train step, so moments and counts are non-zero.
    model = fresh_model(60)
    gen = torch.Generator().manual_seed(61)
    x = torch.rand((2, 4, 1, model.output_shape, model.output_shape), generator=gen)
    y = torch.rand((2, model.forecast_steps, 1, model.output_shape, model.output_shape),
                   generator=gen)
    state = training.init_train_state(model)
    train_step = training.make_train_step(model)
    train_step(state, x, y, torch.Generator().manual_seed(600))
    saved = state.step
    root = tempfile.mkdtemp(prefix="dgmr_orbax_")
    try:
        manager = checkpoint.make_manager(f"{root}/ckpt/latest")
        run_gen = torch.Generator().manual_seed(62)
        t0 = time.perf_counter()
        nbytes = checkpoint.save_jax_state(manager, saved, state, run_gen, {"train/g_loss": 1.0})
        save_s = time.perf_counter() - t0
        pt_bytes = sum(p.numel() * p.element_size() for p in model.parameters())

        # Restore into a fresh state on the card: read + decode, then the copy to the card.
        restored = training.init_train_state(fresh_model(63))
        step_dir = manager.step_dir(saved)
        t0 = time.perf_counter()
        tree = orbax_tree.read_tree(step_dir)
        read_s = time.perf_counter() - t0
        decoded = sum(a.nbytes for a in _leaves(tree))  # numpy arrays: no bfloat16 leaf here
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.restore_jax_state(manager, restored, torch.Generator(), saved, tree=tree)
        torch.cuda.synchronize()
        copy_s = time.perf_counter() - t0
        del tree
        print(f"21 orbax: save_jax_state {nbytes} bytes ({nbytes / pt_bytes:.3f} x the f32 "
              f"parameter bytes {pt_bytes}) in {save_s:.4f} s; restore: read + decode "
              f"{read_s:.4f} s ({decoded / read_s / 1e6:.1f} MB/s of {decoded} decoded bytes, "
              f"raw-block frames), convert + copy to the card {copy_s:.4f} s; on {card}")

        # Every parameter, buffer, Adam moment and step, scheduler count and state.step.
        src, dst = state.model.state_dict(), restored.model.state_dict()
        differ = [k for k in src if not torch.equal(src[k], dst[k])]
        for name, (a, b) in (("g_opt", (state.g_opt, restored.g_opt)),
                             ("d_opt", (state.d_opt, restored.d_opt))):
            sa, sb = a.state_dict(), b.state_dict()
            if len(sa["state"]) != len(a.param_groups[0]["params"]):
                fail(f"21: {name} holds state for {len(sa['state'])} of "
                     f"{len(a.param_groups[0]['params'])} parameters after a train step")
            differ += [f"{name}.{i}.{k}" for i, st in sa["state"].items() for k in st
                       if not torch.equal(st[k], sb["state"][i][k])]
            if sa["param_groups"] != sb["param_groups"]:
                differ.append(f"{name}.param_groups")
        for name in ("g_sched", "d_sched"):
            if getattr(state, name).last_epoch != getattr(restored, name).last_epoch:
                differ.append(f"{name}.last_epoch")
        if restored.step != state.step:
            differ.append("step")
        print(f"21 orbax: restored state against the source: {len(src)} model tensors, "
              f"{len(state.g_opt.state) + len(state.d_opt.state)} Adam states, both schedulers' "
              f"last_epoch and state.step; torch.equal except {differ}")
        if differ:
            fail(f"21: the restored state differs from the source: {differ[:10]}")

        # The eval step through both f32 kernels, on the source and on the restored state.
        evals = []
        for st in (state, restored):
            for counter in counters:
                counter.launches = 0
            out = training.make_eval_step(st.model)(st, x, y, torch.Generator().manual_seed(610))
            evals.append(({k: v.clone() for k, v in out.items()}, launch_counts(counters)))
        expected = expected_launches(2 + model.generation_steps)
        values = {k: v.item() for k, v in evals[1][0].items()}
        print(f"21 orbax: eval step launches {evals[0][1]} (source) and {evals[1][1]} "
              f"(restored), expected {expected}; metrics {json.dumps(values)}")
        if evals[0][1] != expected or evals[1][1] != expected:
            fail(f"21: eval step launches {evals[0][1]} / {evals[1][1]}, expected {expected}")
        if any(not torch.equal(evals[0][0][k], evals[1][0][k]) for k in evals[0][0]):
            fail("21: the restored model's eval step differs from the source's")
        eval_launches = evals[1][1]

        # The next train step from both, with the same draws, cuDNN deterministic.
        was = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        try:
            outs = []
            for st in (state, restored):
                m = training.make_train_step(st.model)(st, x, y, torch.Generator().manual_seed(620))
                outs.append({k: v.clone() for k, v in m.items()})
        finally:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = was
        loss_differ = [k for k in outs[0] if not torch.equal(outs[0][k], outs[1][k])]
        src, dst = state.model.state_dict(), restored.model.state_dict()
        param_differ = [k for k in src if not torch.equal(src[k], dst[k])]
        worst = max(((src[k].float() - dst[k].float()).abs().max().item()
                     / max(src[k].float().abs().max().item(), 1e-30) for k in param_differ),
                    default=0.0)
        print(f"21 orbax: the next train step (cuDNN deterministic) from the source and the "
              f"restored state: metrics differ {loss_differ}, {len(param_differ)} of {len(src)} "
              f"model tensors differ (worst {worst:.3e} of a tensor's max)")
        if loss_differ or param_differ:
            fail(f"21: the next train step differs: metrics {loss_differ}, tensors "
                 f"{param_differ[:10]}")
        del restored, outs, evals
        torch.cuda.empty_cache()

        # A Trainer on that ckpt_dir resumes from the Orbax step and takes one step.
        trainer = Trainer(fresh_model(64), max_steps=saved + 1, ckpt_dir=f"{root}/ckpt",
                          ckpt_every=1, log_every=1, prefetch=0, seed=65)
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            resumed = trainer.fit(synthetic_radar_batches_device(batch_size=2, seed=66))
        fit_s = time.perf_counter() - t0
        said = [line for line in err.getvalue().splitlines() if "resumed" in line]
        kinds = {s: manager.kind(s) for s in manager.all_steps()}
        print(f"21 orbax: Trainer on the directory: {said}, ran to step {resumed.step} in "
              f"{fit_s:.4f} s (restore, one step, saves); latest/ {kinds}")
        if said != [f"resumed from step {saved}"] or resumed.step != saved + 1:
            fail(f"21: the Trainer did not resume from step {saved} and take one step")
        if kinds != {saved: "orbax", saved + 1: "torch"}:
            fail(f"21: latest/ holds {kinds}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"orbax_eval_step": eval_launches}


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


def expected_launches(forwards: int, bf16: bool = False) -> dict:
    """4 rollout and 8 GBlock launches per generator forward, all of one dtype's kernels."""
    on, off = ("_bf16", "") if bf16 else ("", "_bf16")
    return {f"convgru_rollout{on}": 4 * forwards, f"gblock_fused{on}": 8 * forwards,
            f"convgru_rollout{off}": 0, f"gblock_fused{off}": 0}


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


def expect_launches(model, counters, calls, forwards: int, what: str, bf16: bool = False) -> dict:
    """Stop counting forwards; fail unless there were ``forwards``, each with 4 / 8 launches."""
    del model.forward
    got = launch_counts(counters)
    want = expected_launches(forwards, bf16)
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
    """Phase 9: save and reload the full-width model five ways; each nowcast bit-identical."""
    import shutil
    from pathlib import Path

    from skillful_nowcasting_tpu_torch import DGMR, models
    from skillful_nowcasting_tpu_torch.hub import compose_generator
    from skillful_nowcasting_tpu_torch.hub import safetensors as st
    from skillful_nowcasting_tpu_torch.hub.pretrained import reference_state_dict, save_checkpoint

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

        # The JAX package's native format, written by the port (its file is what the JAX
        # package's BoundModel.save_pretrained writes; tests/test_torch_serialization.py).
        def write_msgpack(label, parts):
            t0 = time.perf_counter()
            nbytes = sum(save_checkpoint(module, str(root / name)) for name, module in parts)
            print(f"hub msgpack {label}: {nbytes} bytes of flax_model.msgpack written in "
                  f"{time.perf_counter() - t0:.4f} s from {card}")
            return nbytes

        nbytes = write_msgpack("DGMR", [("msgpack", model)])
        check("save_checkpoint (flax_model.msgpack) -> DGMR.from_pretrained",
              lambda: DGMR.from_pretrained(str(root / "msgpack")), nbytes)
        nbytes = write_msgpack("three stacks", [(f"msgpack_{name}", getattr(model, name))
                                                for name, _ in stacks])
        check("three stacks apart (flax_model.msgpack) -> compose_generator",
              lambda: compose_generator(*(cls.from_pretrained(str(root / f"msgpack_{name}"))
                                          for name, cls in stacks)), nbytes)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"hub": expect_launches(model, counters, calls, 6, "hub nowcasts (source + 5 loaded)")}


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
    resident = tiled_nowcast_device(model, torch.from_numpy(frames).to(dev), tile=tile,
                                    overlap=overlap, batch_tiles=TILE_BATCH, z=z)
    if not np.array_equal(resident, out["tiled_nowcast_device"]):
        fail("tiled_nowcast_device: a card-resident field gives other bits than the host field")
    print("tiled_nowcast_device: the field handed over on the card is bit-identical to the host's")

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


def artifact_full_width(torch, dev, model, card, counters) -> dict:
    """Phase 14: the serving artifact of the paper config, B=2, S=6, f32 (and a bf16 one)."""
    import os
    import shutil
    from pathlib import Path

    from skillful_nowcasting_tpu_torch import serving
    from skillful_nowcasting_tpu_torch.inference import make_generate

    root = Path(__file__).resolve().parent / "build" / "chip_smoke_artifact"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    batch = 2
    x = torch.rand((batch, 4, 1, model.output_shape, model.output_shape),
                   generator=torch.Generator().manual_seed(70))
    try:
        path = str(root / "dgmr.dgmrx")
        t0 = time.perf_counter()
        meta = serving.save_exported(path, model, batch_size=batch)
        total = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server = serving.load_exported(path).place(dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        print(f"artifact (f32, B={batch}, S={meta['num_samples']}): export "
              f"{meta['export_seconds']:.4f} s, save {total - meta['export_seconds']:.4f} s, "
              f"load + place {load_s:.4f} s, {nbytes} bytes, {len(meta['param_names'])} weights "
              f"on {card}; design: {meta['design']}")

        for counter in counters:
            counter.launches = 0
        seconds, outs = [], []
        for i in range(REQUESTS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(server.generate(x, seed=80 + i))
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        launches = launch_counts(counters)
        expected = expected_launches(REQUESTS * meta["num_samples"])
        print(f"artifact: {REQUESTS} requests, seconds {[round(s, 4) for s in seconds]}, "
              f"launches {launches}, expected {expected}")
        if launches != expected:
            fail(f"artifact requests: launches {launches} differ from {expected}")
        out = outs[0]
        if (list(out.shape) != meta["output_shape"] or out.dtype != torch.float32
                or not bool(torch.isfinite(out).all())):
            fail(f"artifact: output {tuple(out.shape)} {out.dtype}, expected {meta['output_shape']}")
        want = make_generate(model)(x, torch.Generator().manual_seed(80))
        err = (out - want).abs().max().item()
        print(f"artifact generate(x, seed=80) vs make_generate(model)(x, manual_seed(80)): "
              f"max_abs_err {err:.3e}, bit-identical {torch.equal(out, want)}")
        if not err <= ARTIFACT_TOL:
            fail(f"artifact and make_generate differ by {err} > {ARTIFACT_TOL}")
        same = torch.equal(server.generate(x.to(dev), seed=80), out)
        print(f"artifact generate from a card-resident x: bit-identical to the host x: {same}")
        if not same:
            fail("artifact: a card-resident x gives other bits than the host x")

        # One forward, the program against the eager model, alternating: the synchronized
        # wall and the host's share (until the call returns, before the synchronize).
        xd = x.to(dev)
        zd = torch.randn((1, *model.latent_stack.shape),
                         generator=torch.Generator().manual_seed(81)).to(dev)
        timing = {"eager": [], "artifact": []}
        calls = {"eager": lambda: model(xd, z=zd),
                 "artifact": lambda: server.call(xd, zd, server.weights)}
        with torch.inference_mode():
            for name in ("eager", "artifact", "artifact", "eager") * 2:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                calls[name]()
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                timing[name].append((1e3 * (t1 - t0), 1e3 * (time.perf_counter() - t0)))
        for name, runs in timing.items():
            print(f"artifact diagnostics, one B={batch} forward, {name}: host ms "
                  f"{[round(h, 2) for h, _ in runs]}, synchronized wall ms "
                  f"{[round(w, 2) for _, w in runs]} on {card}")

        names = meta["param_names"]
        idx = max((i for i, n in enumerate(names) if n.startswith("sampler.")),
                  key=lambda i: server.weights[i].numel())
        saved = server.weights[idx]
        server.weights[idx] = saved + 0.05
        moved = (server.generate(x, seed=80) - out).abs().max().item()
        server.weights[idx] = saved
        print(f"artifact: {names[idx]} + 0.05 (no new export) moves the nowcast by {moved:.3e}")
        if not moved > 0:
            fail("artifact: replacing a sampler weight did not change the nowcast")

        path16 = str(root / "dgmr_bf16.dgmrx")
        meta16 = serving.save_exported(path16, model, batch_size=batch,
                                       compute_dtype=torch.bfloat16)
        server16 = serving.load_exported(path16).place(dev)
        for counter in counters:
            counter.launches = 0
        out16 = server16.generate(x, seed=80)
        launches16 = launch_counts(counters)
        rel = (out16 - out).abs().max().item() / max(out.abs().max().item(), 1e-3)
        print(f"artifact (compute_dtype bfloat16): export {meta16['export_seconds']:.4f} s, "
              f"{os.path.getsize(path16)} bytes; output {out16.dtype}, finite "
              f"{bool(torch.isfinite(out16).all())}, launches {launches16}, "
              f"max|bf16 - f32| / scale {rel:.4f}")
        if out16.dtype != torch.float32 or not bool(torch.isfinite(out16).all()):
            fail(f"bf16 artifact: output {out16.dtype}, not finite f32")
        if launches16 != expected_launches(meta16["num_samples"], bf16=True):
            fail(f"bf16 artifact: launches {launches16}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"artifact": launches, "artifact_bf16": launches16}


def bf16_full_width(torch, dev, model, card, counters):
    """Phase 15: bf16 requests, bf16 against f32, a bf16 MRMS field, a bf16 layer breakdown."""
    import numpy as np

    from skillful_nowcasting_tpu_torch.inference import make_generate, tiled_nowcast_device
    from skillful_nowcasting_tpu_torch.ops import upsample_gblock_fused

    batch = 2
    s_n, fs, size = model.num_samples, model.forecast_steps, model.output_shape
    x = torch.rand((batch, 4, 1, size, size), generator=torch.Generator().manual_seed(90))
    generate = make_generate(model)
    for counter in counters:
        counter.launches = 0
    upsample_gblock_fused.launches = upsample_gblock_fused.launches_bf16 = 0
    seconds = []
    for i in range(REQUESTS):
        t0 = time.perf_counter()
        out = generate(x.bfloat16(), torch.Generator().manual_seed(100 + i))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        if (tuple(out.shape) != (s_n, batch, fs, 1, size, size) or out.dtype != torch.bfloat16
                or not bool(torch.isfinite(out).all())):
            fail(f"bf16 request {i}: output {tuple(out.shape)} {out.dtype}, or not finite")
    launches = launch_counts(counters)
    expected = expected_launches(REQUESTS * s_n, bf16=True)
    launches["upsample_gblock_fused"] = upsample_gblock_fused.launches
    launches["upsample_gblock_fused_bf16"] = upsample_gblock_fused.launches_bf16
    expected.update(upsample_gblock_fused=0, upsample_gblock_fused_bf16=8 * REQUESTS * s_n)
    print(f"bf16 launches: {launches}, expected {expected}")
    if launches != expected:
        fail(f"the bf16 path's kernel launches {launches} differ from {expected}")
    frames = s_n * batch * fs
    print(f"bf16 slice: {REQUESTS} requests of {s_n} samples x {batch} x {fs} frames at "
          f"{size}^2, seconds {[round(s, 4) for s in seconds]}, frames/s "
          f"{[round(frames / s, 2) for s in seconds]} on {card}")

    z = torch.randn((1, *model.latent_stack.shape), generator=torch.Generator().manual_seed(91))
    with torch.inference_mode():
        y32 = model(x.to(dev), z=z.to(dev))
        y16 = model(x.to(dev).bfloat16(), z=z.to(dev)).float()
    rel = (y16 - y32).abs().max().item() / max(y32.abs().max().item(), 1e-3)
    print(f"bf16 vs f32 (B=2, fixed z): max|bf16 - f32| / max(max|f32|, 1e-3) = {rel:.4f} "
          f"(limit {BF16_TOL}); max|f32| {y32.abs().max().item():.4f}")
    if not rel < BF16_TOL:
        fail(f"bf16 and f32 nowcasts differ by {rel} of scale >= {BF16_TOL}")

    h, w = MRMS
    frames_np = torch.rand((4, 1, h, w), generator=torch.Generator().manual_seed(40)).numpy()
    zt = torch.randn((1, 8, 8, 8), generator=torch.Generator().manual_seed(41))
    calls = counted_forwards(model, counters)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    field = tiled_nowcast_device(model, frames_np, z=zt, dtype=torch.bfloat16)
    mrms_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n_tiles = device_tiles(h, w)
    mrms = expect_launches(model, counters, calls, -(-n_tiles // TILE_BATCH),
                           f"MRMS bf16 {h}x{w}, {n_tiles} tiles", bf16=True)
    if field.shape != (fs, 1, h, w) or field.dtype != np.float32 or not np.isfinite(field).all():
        fail(f"bf16 MRMS field: output {field.shape} {field.dtype}, finite "
             f"{np.isfinite(field).all()}")
    print(f"MRMS bf16 {h}x{w}, 18 steps: {mrms_s:.4f} s, {n_tiles / mrms_s:.2f} tiles/s, "
          f"peak device memory {peak / 2**30:.3f} GiB (max_memory_allocated), f32 output, "
          f"on {card}")
    del field

    layer_times(torch, model, x.to(dev).bfloat16(), card, tag=" bf16")
    return launches, {"mrms_field_bf16": mrms}


# ---------------------------------------------------------------------------
# 17. Data parallelism on one card: two gloo ranks on cuda:0, each its own process.

DP_RANKS = 2
DP_TIMEOUT = 420  # seconds for both ranks together; the kernels are built before they start
# 17c's tiles a forward: half of phase 10's 16. Two ranks' f32 tile batches share one card's
# memory, and where a cuDNN conv cannot allocate its preferred workspace it takes another
# algorithm, with other bits (two ranks at 16 tiles did, 8.9e-08 apart; one rank alone or
# both at 8 tiles did not).
DP_TILE_BATCH = 8
DP_SCALING_NOTE = ("two ranks share one card's SMs and gloo stages every collective through "
                   "the host: these figures say nothing of multi-card scaling")


def card_name() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    return f"{smi} (nvidia-smi name, power.limit)"


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def bits_checksum(torch, tensors, device):
    """Two int64 sums of every tensor's bits (plain and position-weighted, wrapping mod 2^64)."""
    acc = torch.zeros(2, dtype=torch.int64, device=device)
    for t in tensors:
        v = t.detach().reshape(-1)
        v = v.view(torch.int32 if v.element_size() == 4 else torch.int64).to(torch.int64)
        w = torch.arange(1, v.numel() + 1, dtype=torch.int64, device=device)
        acc[0] += v.sum()
        acc[1] += (v * w).sum()
    return acc


def worst_rel(got: dict, want: dict) -> tuple:
    """Largest max-abs difference over a tensor's max-abs (floored at 1e-6 of the group's largest)."""
    top = max(v.abs().max().item() for v in want.values())
    return max(((got[k] - w).abs().max().item() / max(w.abs().max().item(), 1e-6 * top), k)
               for k, w in want.items())


def dp_tiny_parity(torch, rank, dev, meshes, say) -> None:
    """17a: both DP modes, tiny config, float64, SGD: 2 card ranks against 2 CPU ranks; pjit
    on 2 x B=1 against the plain step at B=2 on the card."""
    from skillful_nowcasting_tpu_torch import DGMR, training
    from skillful_nowcasting_tpu_torch.parallel import make_dp_train_step
    from skillful_nowcasting_tpu_torch.utils import random_fill

    base = training.desaturate_discriminator(
        random_fill(DGMR(**TINY, device="cpu"), torch.Generator().manual_seed(90)))
    gen = torch.Generator().manual_seed(91)
    x = torch.rand((2, 4, 1, 64, 64), generator=gen).double()
    y = torch.rand((2, 2, 1, 64, 64), generator=gen).double()
    per_rank = training.draw_step(base, 6, torch.Generator().manual_seed(92 + rank))
    shared = training.draw_step(base, 6, torch.Generator().manual_seed(95))
    mine = slice(rank, rank + 1)

    def one(mode, device, mesh, draws, rows):
        model = DGMR(**TINY, device=device)
        model.load_state_dict(base.state_dict())
        model.double()
        g, d = training.split_params(model)
        state = training.init_train_state(
            model, (torch.optim.SGD(g.values(), lr=5e-5), torch.optim.SGD(d.values(), lr=2e-4)))
        step = (training.make_train_step(model, return_grads=True) if mesh is None else
                make_dp_train_step(model, mesh, mode=mode, return_grads=True))
        m = step(state, x[rows], y[rows], draws=draws)
        cpu = lambda v: v.detach().to("cpu", torch.float64)  # noqa: E731
        return {"losses": {k: cpu(v).reshape(1) for k, v in m.items() if k.startswith("train/")},
                "g grads": {k: cpu(v) for k, v in m["g_grads"].items()},
                "d grads": {k: cpu(v) for k, v in m["d_grads"].items()},
                "params": {k: cpu(p) for k, p in model.named_parameters()}}

    results = {}
    for mode, draws in (("shard_map", per_rank), ("pjit", shared)):
        card = results[mode] = one(mode, dev, meshes["card"], draws, mine)
        host = one(mode, "cpu", meshes["cpu"], draws, mine)
        worst = max(worst_rel(card[g], host[g]) + (g,) for g in card)
        say(f"17a {mode} float64 (2 card ranks vs 2 CPU ranks, one tiny SGD step, B=1 a rank): "
            f"worst {worst[0]:.3e} of the tensor's max-abs at {worst[2]} {worst[1]}")
        if not worst[0] <= TRAIN_TOL:
            fail(f"DP {mode}: card and CPU ranks differ by {worst[0]} > {TRAIN_TOL}")
    if rank == 0:  # the pjit ranks' averaged result is the global batch's step
        plain = one(None, dev, None, shared, slice(0, 2))
        worst = max(worst_rel(results["pjit"][g], plain[g]) + (g,) for g in plain)
        say(f"17a pjit on 2 ranks x B=1 vs the plain step at B=2 (card, float64): worst "
            f"{worst[0]:.3e} of the tensor's max-abs at {worst[2]} {worst[1]}")
        if not worst[0] <= TRAIN_TOL:
            fail(f"DP pjit differs from the global-batch step by {worst[0]} > {TRAIN_TOL}")


def dp_trainer_full_width(torch, rank, dev, mesh, root, counters, say) -> dict:
    """17b: Trainer.fit on 2 ranks (shard_map, bf16, R1), stopped by SIGTERM after step 2 on
    rank 1 only, then resumed by new Trainers to step 3; replicas checked after every step."""
    import torch.distributed as dist

    import skillful_nowcasting_tpu_torch.trainer as trainer_module
    from skillful_nowcasting_tpu_torch import DGMR, checkpoint, training
    from skillful_nowcasting_tpu_torch.data import synthetic_radar_batches_device
    from skillful_nowcasting_tpu_torch.parallel import gather_rows
    from skillful_nowcasting_tpu_torch.parallel import mesh as pmesh
    from skillful_nowcasting_tpu_torch.utils import random_fill

    saves, reduces, restored = [], [], []
    save, reduce_, restore = (checkpoint.CheckpointManager.save, pmesh.all_reduce_mean_,
                              trainer_module.restore_state)

    def counted_save(self, step, payload, metrics=None):
        saves.append(step)
        return save(self, step, payload, metrics)

    def timed_reduce(tensors, group):
        tensors = list(tensors)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reduce_(tensors, group)
        torch.cuda.synchronize()
        reduces.append((sum(t.numel() * t.element_size() for t in tensors),
                        time.perf_counter() - t0))

    def recorded_restore(*args, **kw):
        restored.append(restore(*args, **kw))
        return restored[-1]

    checkpoint.CheckpointManager.save = counted_save
    pmesh.all_reduce_mean_ = timed_reduce
    trainer_module.restore_state = recorded_restore

    def fresh_model(seed):  # other weights on each rank: fit starts every rank from rank 0's
        return training.desaturate_discriminator(
            random_fill(DGMR(), torch.Generator().manual_seed(seed)))

    def make_trainer(model, max_steps, sigterm_after=None):
        trainer = trainer_module.Trainer(
            model, max_steps=max_steps, ckpt_dir=f"{root}/ckpt", log_dir=f"{root}/log",
            compute_dtype=torch.bfloat16, r1_gamma=R1_GAMMA, ckpt_every=2, val_every=2,
            log_every=1, prefetch=2, seed=50, mesh=mesh, dp_mode="shard_map")
        step = trainer.train_step
        seconds, equal = [], []

        def checked(state, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(state, *args, **kw)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            sums = gather_rows(bits_checksum(torch, state.model.state_dict().values(), dev),
                               mesh.group)
            equal.append(bool((sums == sums[0]).all()))
            if not equal[-1]:
                fail(f"17b: the replicas differ after step {state.step}: checksums {sums.tolist()}")
            if sigterm_after == state.step:  # held by the Trainer to the step's end
                os.kill(os.getpid(), signal.SIGTERM)
            return metrics

        trainer.train_step = checked
        return trainer, seconds, equal

    try:
        model = fresh_model(60 + rank)
        g, d = training.split_params(model)
        g_bytes, d_bytes = (sum(p.numel() * p.element_size() for p in ps.values()) for ps in (g, d))
        trainer, seconds, equal = make_trainer(model, 10, sigterm_after=2 if rank == 1 else None)
        for counter in counters:
            counter.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = trainer.fit(synthetic_radar_batches_device(batch_size=2, seed=70 + rank),
                            synthetic_radar_batches_device(batch_size=2, seed=72 + rank))
        fit_s = time.perf_counter() - t0
        val_launches = launch_counts(counters)
        forwards = 2 + model.generation_steps
        expected = expected_launches(forwards, bf16=True)
        grads = [(b, s) for b, s in reduces if b in (g_bytes, d_bytes)]
        say(f"17b Trainer.fit (2 ranks, shard_map, bf16, r1_gamma={R1_GAMMA}, B=2 a rank): "
            f"stopped at step {state.step} by SIGTERM to rank 1 in {fit_s:.4f} s; seconds per "
            f"step {[round(s, 4) for s in seconds]}; gradient all-reduces (bytes, seconds) "
            f"{[(b, round(s, 4)) for b, s in grads]} (G {g_bytes} B, D {d_bytes} B); peak "
            f"device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; validation at "
            f"step 2: {forwards} generator forwards, launches {val_launches}, expected "
            f"{expected}; replicas bit-identical after each step {equal} ({DP_SCALING_NOTE})")
        if state.step != 2 or equal != [True, True] or val_launches != expected:
            fail(f"17b: step {state.step}, replicas {equal}, launches {val_launches}")
        if len(grads) != 3 * 2:
            fail(f"17b: {len(grads)} gradient all-reduces in 2 steps, expected 3 a step")
        latest = checkpoint.make_manager(f"{root}/ckpt/latest")
        if rank == 0:
            payload = torch.load(os.path.join(latest.directory, "2", checkpoint.STATE_FILE),
                                 map_location="cpu", weights_only=True, mmap=True)
            n_gen = len(payload.get("rank_generators", []))
            say(f"17b checkpoint: latest/ {latest.all_steps()}, {n_gen} ranks' generator states; "
                f"saves by this rank {saves}")
            if latest.all_steps() != [2] or n_gen != DP_RANKS or saves != [2, 2]:
                fail(f"17b: latest/ {latest.all_steps()}, {n_gen} generators, saves {saves}")
        elif saves:
            fail(f"17b: rank {rank} wrote checkpoints {saves}")
        del trainer, state, model
        torch.cuda.empty_cache()
        dist.barrier()  # rank 0 has read the checkpoint before anyone writes again

        trainer, seconds, equal = make_trainer(fresh_model(80 + rank), 3)
        t0 = time.perf_counter()
        state = trainer.fit(synthetic_radar_batches_device(batch_size=2, seed=74 + rank),
                            synthetic_radar_batches_device(batch_size=2, seed=76 + rank))
        say(f"17b resumed: this rank restored step {restored} and trained to {state.step} in "
            f"{time.perf_counter() - t0:.4f} s (step {[round(s, 4) for s in seconds]} s); replicas "
            f"bit-identical {equal}; latest/ {latest.all_steps()}")
        if restored != [2] or state.step != 3 or equal != [True]:
            fail(f"17b resume: restored {restored}, step {state.step}, replicas {equal}")
        if (rank == 0) != bool(saves[2:]):
            fail(f"17b resume: rank {rank} saves {saves}")
        del trainer, state
        torch.cuda.empty_cache()
    finally:
        checkpoint.CheckpointManager.save = save
        pmesh.all_reduce_mean_ = reduce_
        trainer_module.restore_state = restore
    return {"dp_trainer_validation_bf16": val_launches}, g_bytes + d_bytes


def dp_tilers_and_generate(torch, rank, dev, mesh, counters, say) -> dict:
    """17c: phase 10's 1184^2 field through both tilers on the mesh, and make_dp_generate."""
    import numpy as np
    import torch.distributed as dist

    from skillful_nowcasting_tpu_torch.inference import (
        make_generate,
        smooth_test_field,
        tiled_nowcast,
        tiled_nowcast_device,
    )
    from skillful_nowcasting_tpu_torch.parallel import gather_rows, make_dp_generate

    import gc

    # cuDNN takes the first algorithm whose workspace it can allocate, so free memory can
    # change a conv's bits: start from an empty cache, and print what is free.
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    say(f"17c device memory free at the start: {free / 2**30:.3f} of {total / 2**30:.3f} GiB")
    model = serving_model(torch, dev)  # the same seeded weights on both ranks
    n, tile, overlap = TILED_FIELD, 256, 64
    frames = smooth_test_field(4, n, n, 1, seed=5)
    z = torch.randn((1, 8, 8, 8), generator=torch.Generator().manual_seed(32))
    kw = dict(tile=tile, overlap=overlap, batch_tiles=DP_TILE_BATCH, z=z)
    by_path, out = {}, {}
    # Device tiler: 49 tiles in 7 batches of 8, 4 and 3 a rank. Host tiler: 36 tiles in 5
    # batches of 8, 4 tiles of each a rank (rank 1 has none in the last).
    n_dev = -(-device_tiles(n, n) // DP_TILE_BATCH)
    host_batches = [min(DP_TILE_BATCH, host_tiles(n, n) - s)
                    for s in range(0, host_tiles(n, n), DP_TILE_BATCH)]
    share, per = DP_TILE_BATCH // DP_RANKS, -(-n_dev // DP_RANKS)
    forwards = {"tiled_nowcast_device": max(0, min((rank + 1) * per, n_dev) - rank * per),
                "tiled_nowcast": sum(1 for b in host_batches if b > rank * share)}
    for name, fn in (("tiled_nowcast_device", tiled_nowcast_device),
                     ("tiled_nowcast", tiled_nowcast)):
        calls = counted_forwards(model, counters)
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = fn(model, frames, mesh=mesh, **kw)
        seconds = time.perf_counter() - t0
        by_path[f"{name}_mesh"] = expect_launches(
            model, counters, calls, forwards[name], f"17c {name} {n}^2 on 2 ranks, rank {rank}")
        say(f"17c {name} {n}^2 on 2 ranks: {seconds:.4f} s on this rank ({DP_SCALING_NOTE})")
        if (out[name] is None) != (rank != 0):
            fail(f"17c {name}: rank {rank} returned {type(out[name])}")
    if rank == 0:  # one rank's runs with the same forwards: 8 tiles / 4 tiles a forward
        for name, one in (("tiled_nowcast_device", tiled_nowcast_device(model, frames, **kw)),
                          ("tiled_nowcast", tiled_nowcast(model, frames, **{
                              **kw, "batch_tiles": share}))):
            same = np.array_equal(out[name], one)
            say(f"17c {name} on 2 ranks vs one rank: bit-identical {same}, max |difference| "
                f"{np.abs(out[name] - one).max():.3e}")
            if not same or not np.isfinite(one).all():
                fail(f"17c {name}: the 2-rank field differs from the one-rank field")

    x = torch.rand((DP_RANKS, 4, 1, 256, 256), generator=torch.Generator().manual_seed(34))
    calls = counted_forwards(model, counters)
    mine = make_dp_generate(model, mesh, num_samples=2)(x, torch.Generator().manual_seed(35))
    by_path["dp_generate"] = expect_launches(model, counters, calls, 2,
                                             f"17c make_dp_generate S=2, rank {rank}")
    own = make_generate(model, 2)(x[rank:rank + 1], torch.Generator().manual_seed(35))
    rows = gather_rows(mine.contiguous(), mesh.group)
    if not torch.equal(mine, own):
        fail(f"17c make_dp_generate: rank {rank}'s share differs from make_generate of its rows")
    if rank == 0:
        whole = make_generate(model, 2)(x, torch.Generator().manual_seed(35))
        err = (torch.cat(list(rows), dim=1) - whole).abs().max().item()
        say(f"17c make_dp_generate vs make_generate (same latents): each rank's share "
            f"bit-identical to make_generate of its rows; gathered vs the B=2 batch max_abs_err "
            f"{err:.3e} (the kernels' split-K plan depends on the batch)")
        if not err <= KERNEL_TOL:
            fail(f"17c make_dp_generate differs from make_generate by {err}")
    dist.barrier()
    del model
    torch.cuda.empty_cache()
    return by_path


def dp_halo(torch, rank, dev, mesh, say) -> None:
    """halo_conv2d on CUDA tensors over gloo (halo rows staged through the host) vs a dense conv."""
    import torch.nn.functional as F

    from skillful_nowcasting_tpu_torch.parallel import gather_rows, halo_conv2d

    gen = torch.Generator().manual_seed(36)
    x = torch.randn((2, 48, 64, 64), generator=gen).to(dev)
    w = (torch.randn((48, 48, 3, 3), generator=gen) / 20).to(dev)
    mine = halo_conv2d(x[:, :, rank * 32:(rank + 1) * 32], w, mesh.group)
    whole = torch.cat(list(gather_rows(mine.contiguous(), mesh.group)), dim=2)
    err = (whole - F.conv2d(x, w, padding=1)).abs().max().item()
    say(f"17 halo_conv2d on 2 ranks (gloo, CUDA tensors; the halo rows staged through the host) "
        f"vs the dense conv: max_abs_err {err:.3e}")
    if not err <= KERNEL_TOL:
        fail(f"17 halo_conv2d differs from the dense conv by {err}")


def rank_setup(args, prefix: str):
    """A rank's start (``--dp-rank``): TF32 off, its launch counters, gloo on cuda:0.

    Returns ``(torch, rank, dev, counters, say)``; ``say`` prints a line under
    ``prefix`` with the card's name and power limit.
    """
    import torch
    import torch.distributed as dist
    from datetime import timedelta

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(4)  # two ranks on the card machine's 8 cores
    from skillful_nowcasting_tpu_torch.ops import convgru_rollout, gblock_fused

    rank, dev = args.dp_rank, torch.device("cuda", 0)
    card = card_name()

    def say(line: str) -> None:
        print(f"{prefix} {rank}: {line}; on {card}", flush=True)

    counters = (Counter(convgru_rollout, "launches", "convgru_rollout"),
                Counter(gblock_fused, "launches", "gblock_fused"),
                Counter(convgru_rollout, "launches_bf16", "convgru_rollout_bf16"),
                Counter(gblock_fused, "launches_bf16", "gblock_fused_bf16"))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{args.dp_port}", rank=rank,
                            world_size=DP_RANKS, timeout=timedelta(seconds=300))
    return torch, rank, dev, counters, say


def dp_rank_main(args) -> None:
    """One rank of phase 17 (``--dp-rank``): gloo on cuda:0; writes its launches as JSON."""
    torch, rank, dev, counters, say = rank_setup(args, "dp rank")
    from skillful_nowcasting_tpu_torch.parallel import make_mesh

    try:
        meshes = {"card": make_mesh(device=dev), "cpu": make_mesh(device="cpu")}
        marks = [time.perf_counter()]
        dp_tiny_parity(torch, rank, dev, meshes, say)
        marks.append(time.perf_counter())
        by_path, param_bytes = dp_trainer_full_width(torch, rank, dev, meshes["card"],
                                                     args.dp_dir, counters, say)
        marks.append(time.perf_counter())
        by_path.update(dp_tilers_and_generate(torch, rank, dev, meshes["card"], counters, say))
        dp_halo(torch, rank, dev, meshes["card"], say)
        marks.append(time.perf_counter())
        say("17 seconds: a {:.1f}, b {:.1f}, c {:.1f}".format(
            *(b - a for a, b in zip(marks, marks[1:]))))
        with open(os.path.join(args.dp_dir, f"rank{rank}.json"), "w") as f:
            json.dump({"launches": by_path, "param_bytes": param_bytes}, f)
    finally:
        torch.distributed.destroy_process_group()


def run_ranks(phase: int, timeout: float, prefix: str, extra=()) -> list:
    """Start ``DP_RANKS`` ranks of this script for ``phase`` (``--dp-rank``) on cuda:0; their results.

    Each rank writes ``rank<r>.json`` into a scratch directory. A rank that
    fails fails the phase at once; every rank's log is printed, each line
    under ``prefix``.
    """
    root = tempfile.mkdtemp(prefix=f"dgmr_phase{phase}_")
    port = free_port()
    procs, logs = [], []
    try:
        for r in range(DP_RANKS):
            logs.append(open(os.path.join(root, f"rank{r}.log"), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dp-rank", str(r), "--dp-port",
                 str(port), "--dp-dir", root, "--dp-phase", str(phase), *extra], stdout=logs[-1],
                stderr=subprocess.STDOUT, env={**os.environ, "OMP_NUM_THREADS": "4"}))
        t0 = time.perf_counter()
        while any(p.poll() is None for p in procs):  # a failed rank fails the phase at once
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.perf_counter() - t0 > timeout:
                break
            time.sleep(0.5)
        codes = [p.poll() for p in procs]
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for r, log in enumerate(logs):
            log.seek(0)
            for line in log.read().splitlines():
                print(line if line.startswith(prefix) else f"{prefix} {r} | {line}")
        if codes != [0] * DP_RANKS:
            fail(f"phase {phase}: rank exit codes {codes} (None: killed after {timeout} s or "
                 "after the other rank failed)")
        results = []
        for r in range(DP_RANKS):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                results.append(json.load(f))
    finally:
        for log in logs:
            log.close()
        shutil.rmtree(root, ignore_errors=True)
    return results


def data_parallel(torch, dev, card) -> dict:
    """Phase 17: two ranks on cuda:0 over gloo (17a-c in the ranks), then 17d: NCCL, a world of one."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"17 the parent before the ranks start: {torch.cuda.memory_allocated() / 2**30:.3f} GiB "
          f"allocated, {torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved; the card "
          f"{free / 2**30:.3f} of {total / 2**30:.3f} GiB free")
    results = run_ranks(17, DP_TIMEOUT, "dp rank")
    by_path = {f"{path}_rank{r}": counts for r, res in enumerate(results)
               for path, counts in res["launches"].items()}
    nccl_world_of_one(torch, dev, card, results[0]["param_bytes"] // 4)
    gloo_p2p_probe(card)
    return by_path


GLOO_P2P_PROBE = """
import sys
from datetime import timedelta
import torch, torch.distributed as dist
r = int(sys.argv[1])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{sys.argv[2]}", rank=r,
                        world_size=2, timeout=timedelta(seconds=30))
mine, got = torch.full((4,), 1.0 + r, device="cuda:0"), torch.zeros(4, device="cuda:0")
for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, mine, 1 - r),
                                    dist.P2POp(dist.irecv, got, 1 - r)]):
    work.wait()
torch.cuda.synchronize()
print("received", got.tolist(), "expected", [2.0 - r] * 4)
"""


def gloo_p2p_probe(card) -> None:
    """Whether gloo's point-to-point calls take CUDA tensors: two throwaway processes try it.

    A diagnostic (it fails nothing): ``halo_exchange`` stages a gloo group's
    halo rows through the host either way.
    """
    port = free_port()
    procs = [subprocess.Popen([sys.executable, "-c", GLOO_P2P_PROBE, str(r), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=90)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(p.communicate()[0] + " (killed after 90 s)")
    lines = [(o.strip().splitlines() or ["no output"])[-1][:200] for o in outs]
    print(f"17 gloo point-to-point of CUDA tensors (diagnostic): exit codes "
          f"{[p.returncode for p in procs]}, last lines {lines}; on {card}")


def nccl_world_of_one(torch, dev, card, n_params: int) -> None:
    """17d: init_distributed over NCCL from a launcher's environment, a world of one: one
    all-reduce of a buffer the size of the full-width model's gradients, then a train step on
    the mesh of one (the plain step)."""
    import torch.distributed as dist

    from skillful_nowcasting_tpu_torch import DGMR, training
    from skillful_nowcasting_tpu_torch.parallel import (
        init_distributed,
        make_dp_train_step,
        make_mesh,
    )
    from skillful_nowcasting_tpu_torch.utils import random_fill

    env = dict(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        init_distributed(backend="nccl")
        try:
            buf = torch.randn(n_params, generator=torch.Generator().manual_seed(37)).to(dev)
            want = buf.clone()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist.all_reduce(buf)
            torch.cuda.synchronize()
            ar_s = time.perf_counter() - t0
            mesh = make_mesh()
            model = training.desaturate_discriminator(
                random_fill(DGMR(**TINY, device=dev), torch.Generator().manual_seed(38)))
            state = training.init_train_state(model)
            x = torch.rand((2, 4, 1, 64, 64), generator=torch.Generator().manual_seed(39))
            y = torch.rand((2, 2, 1, 64, 64), generator=torch.Generator().manual_seed(40))
            step = make_dp_train_step(model, mesh)
            metrics = step(state, x, y, torch.Generator().manual_seed(41))
            finite = all(bool(torch.isfinite(v)) for v in metrics.values())
            print(f"17d NCCL world of one ({dist.get_backend()}): all-reduce of {n_params} f32 "
                  f"({4 * n_params} bytes, the full-width model's gradients) in {ar_s:.4f} s, "
                  f"unchanged {torch.equal(buf, want)}; mesh {mesh.shape}; a tiny train step on "
                  f"it finite {finite}; NCCL across two or more cards is not verified here; on "
                  f"{card}")
            if not torch.equal(buf, want) or not finite or state.step != 1:
                fail("17d: the NCCL world of one changed the buffer or its step failed")
        finally:
            dist.destroy_process_group()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ---------------------------------------------------------------------------
# 18. Scoring a full-width nowcast with every ported loss, card vs CPU; coord conv; its refusal.
# ---------------------------------------------------------------------------
LOSS_TOL = 1e-5  # card vs CPU, of the CPU's value (f32, TF32 off)
LOSS_GRAD_TOL = 1e-4  # card vs CPU, of the CPU gradient's max-abs


def score_inputs(torch, dev, model, counters) -> dict:
    """18a's tensors on the card: the nowcast ensemble of a seeded radar batch and what scores it."""
    from skillful_nowcasting_tpu_torch.data.synthetic import synthetic_radar_batches_device
    from skillful_nowcasting_tpu_torch.inference import make_generate

    s_n = model.num_samples
    # Advecting blobs of 2-12 (mm/h), over 12: fields of about [0, 1], SSIM's data_range.
    ctx, target = next(synthetic_radar_batches_device(batch_size=2, seed=18, device=dev))
    ctx, target = ctx / 12.0, target / 12.0
    calls = counted_forwards(model, counters)
    ens = make_generate(model)(ctx, torch.Generator().manual_seed(180))
    torch.cuda.synchronize()
    launches = expect_launches(model, counters, calls, s_n, "score nowcast (S=6, B=2)")
    ens = ens.clone()  # a normal tensor (make_generate runs in inference mode), for autograd
    size = model.output_shape
    if tuple(ens.shape) != (s_n, 2, model.forecast_steps, 1, size, size) or not bool(
            torch.isfinite(ens).all()):
        fail(f"score nowcast: shape {tuple(ens.shape)} or non-finite values")
    # A seeded rain probability (kept off 0 and 1 for the logs) and the target's rain labels.
    p = 0.01 + 0.98 * torch.rand(target[:, :, 0].shape, generator=torch.Generator().manual_seed(181))
    probs = torch.stack([1.0 - p, p], 1).to(dev)  # (B, 2, T, H, W): class axis 1
    rain = (target[:, :, 0] > 1.0 / 12.0).long()  # (B, T, H, W): above 1 mm/h
    # The 216 nowcast frames (S*B, T, C, H, W), each sample's target and last context frame.
    frames = ens.flatten(0, 1)
    truth = target.expand(s_n, *target.shape).flatten(0, 1)
    curr = ctx[:, -1:]
    now = curr.expand(s_n, *curr.shape).flatten(0, 1)
    return {"ens": ens, "target": target, "frames": frames, "truth": truth, "now": now,
            "probs": probs, "rain": rain, "launches": launches}


def loss_table(losses, t: dict) -> dict:
    """Every ported loss of 18a's tensors (on their device) as a float."""
    ens, target, frames, truth, now = (t[k] for k in ("ens", "target", "frames", "truth", "now"))
    mean = ens.mean(dim=0)  # the ensemble mean, (B, T, C, H, W)
    log_probs = t["probs"].movedim(1, -1).reshape(-1, 2).log()  # (N, 2)
    labels = t["rain"].reshape(-1)
    args = {"mse": (mean, target), "l1": (mean, target), "focal": (t["probs"], t["rain"]),
            "ssim": (frames, truth), "ms_ssim": (frames, truth), "ssim_dynamic": (now, frames, truth),
            "tv": (mean.flatten(0, 1),), "total_variation": (mean.flatten(0, 1),),
            "gdl": (mean, target), "gradient_difference_loss": (mean, target)}
    for name in ("bce", "binary_crossentropy", "crossentropy"):
        args[name] = (log_probs, labels)
    out = {f"get_loss({name!r})": losses.get_loss(name)(*args[name]) for name in losses.LOSS_NAMES}
    out.update({
        "ssim": losses.ssim(frames, truth),
        "ms_ssim": losses.ms_ssim(frames, truth),
        "ms_ssim(size_average=False)": losses.ms_ssim(frames, truth, size_average=False).sum(),
        "SSIMLossDynamic": losses.SSIMLossDynamic()(now, frames, truth),
        "grid_cell_regularizer": losses.grid_cell_regularizer(ens, target),
        "GridCellLoss": losses.GridCellLoss(weight_fn=losses.weight_fn)(mean, target),
        "FocalLoss": losses.FocalLoss()(t["probs"], t["rain"]),
        "FocalLoss(alpha=[0.25, 0.75])": losses.FocalLoss(alpha=[0.25, 0.75])(t["probs"], t["rain"]),
    })
    return {k: v.item() for k, v in out.items()}


def loss_gradient(criterion, x, y) -> tuple:
    """``d criterion(x, y) / dx`` and the loss's value."""
    x = x.detach().requires_grad_()
    value = criterion(x, y)
    value.backward()
    return x.grad, value.item()


def coord_conv_card_vs_cpu(torch, dev) -> None:
    """18c: CoordConv, both with_r, f32 and bf16, eval and one train forward, card vs CPU."""
    import copy

    from skillful_nowcasting_tpu_torch.layers import CoordConv
    from skillful_nowcasting_tpu_torch.ops import spectral_norm as sn

    gen = torch.Generator().manual_seed(182)
    x = torch.randn((2, 48, 64, 64), generator=gen)  # the context stack's 64^2 x 48 level
    for with_r in (False, True):
        torch.manual_seed(183)
        cpu = CoordConv(48, 96, with_r, kernel_size=3, padding=1, spectral_norm=True)
        card = copy.deepcopy(cpu).to(dev)
        for dtype, tol in ((torch.float32, LOSS_TOL), (torch.bfloat16, KERNEL_TOL_BF16)):
            errs = {}
            for mode in ("eval", "train"):
                outs, advanced = [], []
                for mod, d in ((card, dev), (cpu, torch.device("cpu"))):
                    mod.train(mode == "train")
                    par = mod.conv.parametrizations.weight
                    u0, v0 = par[0]._u.clone(), par[0]._v.clone()
                    with torch.no_grad():
                        outs.append(mod(x.to(d, dtype)).float().cpu())
                        once = sn.power_iteration(sn.kernel_to_weight_mat(par.original), u0, v0,
                                                  par[0].eps)
                    want = once if mode == "train" else (u0, v0)
                    advanced.append(max((a - b).abs().max().item()
                                        for a, b in zip((par[0]._u, par[0]._v), want)))
                scale = outs[1].abs().max().item()
                errs[mode] = (outs[0] - outs[1]).abs().max().item() / scale
                if not (errs[mode] <= tol and max(advanced) <= 1e-6):
                    fail(f"CoordConv(with_r={with_r}) {dtype} {mode}: card vs CPU {errs[mode]} "
                         f"of max|out| (limit {tol}); u / v off one step by {advanced}")
            print(f"score coord conv: CoordConv(48, 96, with_r={with_r}) {str(dtype)[6:]} on "
                  f"(2, 48, 64, 64): card vs CPU eval {errs['eval']:.3e}, train "
                  f"{errs['train']:.3e} of max|out| (limit {tol:.3e}); a train forward "
                  f"advanced SN u / v by exactly one power iteration on both")


def score_nowcast(torch, dev, card, counters) -> dict:
    """Phase 18: a full-width nowcast scored by every ported loss; coord conv; the coord refusal."""
    from skillful_nowcasting_tpu_torch import DGMR, losses

    model = serving_model(torch, dev)
    t = score_inputs(torch, dev, model, counters)
    del model
    torch.cuda.empty_cache()
    # (a) Every loss on the card against the same loss of the same tensors on the CPU.
    on_cpu = {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in t.items()}
    t0 = time.perf_counter()
    card_vals = loss_table(losses, t)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cpu_vals = loss_table(losses, on_cpu)
    t2 = time.perf_counter()
    worst = 0.0
    for name, want in cpu_vals.items():
        got = card_vals[name]
        rel = abs(got - want) / max(abs(want), 1e-30)
        worst = max(worst, rel)
        print(f"score loss {name}: card {got:.9g}, CPU {want:.9g}, relative {rel:.3e}")
        if not (math.isfinite(got) and rel <= LOSS_TOL):
            fail(f"score loss {name}: card {got} vs CPU {want} ({rel} > {LOSS_TOL} relative)")
    print(f"score losses: {len(cpu_vals)} losses of the S=6 x B=2 x 18-frame 256^2 nowcast, "
          f"worst card vs CPU {worst:.3e} relative (limit {LOSS_TOL}); all of them {t1 - t0:.4f} s "
          f"on the card, {t2 - t1:.4f} s on the host's CPU, on {card}")

    # (b) Gradients w.r.t. the nowcast's 216 frames, card vs CPU; the MS-SSIM pass timed.
    frames, truth = t["frames"], t["truth"]
    for name, crit in (("MS_SSIMLoss", losses.MS_SSIMLoss()), ("SSIMLoss", losses.SSIMLoss())):
        runs = []
        for _ in range(2):  # the first pass includes cuDNN's set-up
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            g_card, v_card = loss_gradient(crit, frames, truth)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0, (torch.cuda.max_memory_allocated() - base) / 2**30))
        g_cpu, v_cpu = loss_gradient(crit, on_cpu["frames"], on_cpu["truth"])
        scale = g_cpu.abs().max().item()
        err = (g_card.cpu() - g_cpu).abs().max().item() / scale
        print(f"score gradient {name} (forward + backward, {frames.shape[0] * frames.shape[1]} "
              f"frames of 256^2): loss {v_card:.9g} (CPU {v_cpu:.9g}), gradient card vs CPU "
              f"{err:.3e} of max|grad| {scale:.3e} (limit {LOSS_GRAD_TOL}); seconds "
              f"{[round(s, 4) for s, _ in runs]}, peak memory above the inputs "
              f"{[round(m, 3) for _, m in runs]} GiB on {card}")
        if not (scale > 0 and bool(torch.isfinite(g_card).all()) and err <= LOSS_GRAD_TOL):
            fail(f"score gradient {name}: card vs CPU {err} of max-abs {scale}")
    launches = t["launches"]
    del t, on_cpu, frames, truth, g_card
    torch.cuda.empty_cache()

    # (c) Coord conv; (d) the blocks refuse conv_type="coord", as the JAX blocks cannot run it.
    coord_conv_card_vs_cpu(torch, dev)
    try:
        DGMR(conv_type="coord")
    except TypeError as e:
        print(f"score refusal: DGMR(conv_type='coord') raises TypeError: {e}")
    else:
        fail("DGMR(conv_type='coord') was built; the blocks must refuse it")
    return {"score": launches}



# Phase 19: the generator forward H-sharded over the two ranks of a (data=1, space=2) mesh.
SPACE_SIZE = 512  # 16 latent rows: 8 a rank, the deepest state's even split
SPACE_LARGE = 1024  # 19e, bf16
SPACE_BUCKET = f"space_windows_{SPACE_SIZE}"
SPACE_F32_TOL = 1e-4  # of max|dense|
# bf16: of each frame's max|dense|, four bf16 ulps of its largest value. One ulp (2^-7) is not
# met by the dense bf16 forward against itself: the same sample at B=2 and at B=1 (other cuDNN
# plans; both kernels are bit-invariant to a window's rows) differ by up to two ulps of a
# frame's max, and the sharded forward by two (PERF.md, section 6). Each bf16 case prints that
# spread and the one-ulp verdict beside its result. A wrong halo row is off by O(1) there.
SPACE_BF16_TOL = 2.0**-5
SPACE_TIMEOUT = 300  # seconds for both ranks together
SPACE_NOTE = ("two ranks share one card's SMs and gloo stages every halo through the host: these "
              "figures show the layout's semantics and costs, not scaling")


def space_levels(size: int, steps: int) -> list:
    """Per Sampler level on 2 space ranks: (rows, stripe rows, rollout window, GBlock window).

    Each rank has one neighbour: a window is the stripe and the rows a kernel
    reaches on the neighbour's side (2 T + 1 for the rollout, 2 for the
    GBlock), clipped to the level.
    """
    out = []
    for level in range(4):
        rows = size // 32 * 2**level
        stripe = rows // DP_RANKS
        out.append((rows, stripe, min(rows, stripe + 2 * steps + 1), min(rows, stripe + 2)))
    return out


def first_parting_layers(torch, model, x, z, say, tag: str, show: int = 5) -> None:
    """Where a dense forward of one sample starts to depend on its batch: B=1 against B=2.

    Every module's output is recorded in the order the modules finish, for
    ``x`` alone and for ``x`` twice in a batch; sample 0's part of each (the
    batch axis is the first one that doubles, T-major folds included) is
    compared bit for bit, and the first modules whose outputs part are printed
    with their largest difference over their largest value.
    """
    outputs, hooks = [], []

    def record(name):
        def hook(module, _inputs, out):
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    outputs.append((name, type(module).__name__, t))
        return hook

    for name, module in model.named_modules():
        hooks.append(module.register_forward_hook(record(name or "model")))
    try:
        with torch.inference_mode():
            model(x, z=z)
            alone, outputs[:] = list(outputs), []
            model(torch.cat([x, x]), z=z)
            paired = list(outputs)
    finally:
        for h in hooks:
            h.remove()
        outputs.clear()
    parted = []
    for (name, kind, one), (_, _, two) in zip(alone, paired):
        if one.shape != two.shape:  # the first axis that doubles holds the batch, innermost
            d = next(i for i, (a, b) in enumerate(zip(one.shape, two.shape)) if b == 2 * a)
            two = two.unflatten(d, (one.shape[d], 2)).select(d + 1, 0)
        if not torch.equal(one, two):
            diff = (one.float() - two.float()).abs().max().item()
            parted.append((name, kind, diff / max(one.float().abs().max().item(), 1e-30)))
    say(f"{tag}: the sample alone (B=1) against the same sample in a B=2 batch, dense: "
        f"{len(parted)} of {len(alone)} module outputs part; the first "
        f"{[(n, kind, f'{rel:.3e}') for n, kind, rel in parted[:show]]} (module, type, max|diff| "
        "over its max|B=1|, in the order the modules finish)")
    del alone, paired


def spatial_case(torch, model, mesh, x, z, dtype, counters, say) -> dict:
    """19b-d on one rank for one field and dtype: launches, the sharded forward against the dense one."""
    import skillful_nowcasting_tpu_torch.layers.convgru as convgru_mod
    import skillful_nowcasting_tpu_torch.models.common as common_mod
    from skillful_nowcasting_tpu_torch import profiling
    from skillful_nowcasting_tpu_torch.parallel import (
        gather_space,
        halo_exchange,
        halo_window,
        make_spatial_forward,
        reset_halo_counters,
    )

    bf16 = dtype == torch.bfloat16
    size, steps = x.shape[-1], model.forecast_steps
    tag = f"19 {size}^2 {'bf16' if bf16 else 'f32'}"
    x = x.to(dtype)
    fwd = make_spatial_forward(model, mesh)
    comms = (halo_window, halo_exchange)

    # (c) The first forward, counted from 0: 4 / 8 launches of x's dtype, the windows' rows.
    windows = {"rollout": [], "gblock": []}  # (rows, W, C) of each kernel's input

    def watched(name, fn, arg):
        def wrapper(*args, **kwargs):
            windows[name].append(tuple(args[arg].shape[1:]))
            return fn(*args, **kwargs)
        return wrapper

    rollout, gblock = convgru_mod.convgru_rollout, common_mod.gblock_fused
    convgru_mod.convgru_rollout = watched("rollout", rollout, 1)  # h0 (B, H, W, C)
    common_mod.gblock_fused = watched("gblock", gblock, 0)  # x (N, H, W, Cin)
    for counter in counters:
        counter.launches = 0
    reset_halo_counters()
    try:
        with torch.inference_mode():
            y = fwd(x, z=z)
        torch.cuda.synchronize()
    finally:
        convgru_mod.convgru_rollout, common_mod.gblock_fused = rollout, gblock
    launches, want = launch_counts(counters), expected_launches(1, bf16)
    say(f"{tag}: launches of one sharded forward {launches}, expected {want}; halo_window "
        f"{halo_window.calls} calls, halo_exchange {halo_exchange.calls}")
    if launches != want or not halo_window.calls > 0:
        fail(f"{tag}: launches {launches} (expected {want}), {halo_window.calls} halo_window calls")
    levels = space_levels(size, steps)
    factors = [round(w[0] / lv[1], 4) for w, lv in zip(windows["rollout"], levels)]
    say(f"{tag}: the rollout's windows (rows, W, C) {windows['rollout']} for stripes of "
        f"{[lv[1] for lv in levels]} rows: recompute factor per level {factors}; the GBlock's "
        f"windows {windows['gblock']}")
    if [w[0] for w in windows["rollout"]] != [lv[2] for lv in levels] or \
            [w[0] for w in windows["gblock"]] != [lv[3] for lv in levels]:
        fail(f"{tag}: the kernels' windows differ from {levels}")

    # (b, d) A timed forward of each, both ranks starting together; peak memory above the inputs.
    def timed(fn):
        torch.distributed.barrier()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, (torch.cuda.max_memory_allocated() - base) / 2**30

    reset_halo_counters()
    with profiling.record() as log:
        y, sec, peak = timed(lambda: fwd(x, z=z))
    comm = {fn.__name__: (fn.calls, fn.bytes, span_seconds(log, name))
            for fn, name in zip(comms, ("dgmr.halo.window", "dgmr.halo.exchange"))}
    with torch.inference_mode():
        whole = gather_space(y, mesh)
        model(x, z=z)  # the dense forward's warm-up
    dense, dense_sec, dense_peak = timed(lambda: model(x, z=z))
    if tuple(y.shape) != (1, steps, 1, size // DP_RANKS, size) or \
            whole.shape != dense.shape or not bool(torch.isfinite(whole).all()):
        fail(f"{tag}: stripe {tuple(y.shape)}, gathered {tuple(whole.shape)}, or non-finite")
    def frame_err(a, b) -> float:  # worst frame of (B, T): max|a - b| over the frame's max|b|
        a, b = a.float(), b.float()
        return ((a - b).abs().amax(dim=(-3, -2, -1))
                / b.abs().amax(dim=(-3, -2, -1)).clamp_min(1e-30)).max().item()

    equal = (whole == dense).float().mean().item()
    if bf16:
        err, tol, of = frame_err(whole, dense), SPACE_BF16_TOL, "of its frame's max|dense|"
        with torch.inference_mode():  # the dense forward's own spread: this sample in a B=2 batch
            again = model(torch.cat([x, x]), z=z)[:1]
        spread = (f"; one bf16 ulp (2^-7) {'met' if err <= 2.0**-7 else 'not met'}; the dense "
                  f"forward's own spread (the sample at B=2 against B=1) "
                  f"{frame_err(again, dense):.3e}, {100 * (again == dense).float().mean().item():.4f}% "
                  "bit-equal")
        del again
        if size == SPACE_SIZE and mesh.rank == 0:  # where that spread starts (the card is shared)
            first_parting_layers(torch, model, x, z, say, tag)
    else:
        err = (whole - dense).abs().max().item() / dense.abs().max().item()
        tol, of, spread = SPACE_F32_TOL, "of max|dense|", ""
    say(f"{tag}: gathered sharded nowcast vs the dense forward {err:.3e} {of} (limit {tol:.3e}), "
        f"{100 * equal:.4f}% of elements bit-equal{spread}")
    say(f"{tag}: a forward (after a warm-up) sharded {sec:.4f} s, dense {dense_sec:.4f} s; peak "
        f"memory above the inputs sharded {peak:.3f} GiB, dense {dense_peak:.3f} GiB; halo "
        f"(calls, bytes received, host seconds) of the sharded forward {comm} ({SPACE_NOTE})")
    if not err <= tol:
        fail(f"{tag}: the sharded nowcast differs from the dense one by {err} > {tol} {of}")
    return launches


def spatial_rank_main(args) -> None:
    """One rank of phase 19 (``--dp-rank``, ``--dp-phase 19``): 19b-e; writes its launches as JSON."""
    torch, rank, dev, counters, say = rank_setup(args, "space rank")
    from skillful_nowcasting_tpu_torch.data.synthetic import synthetic_radar_batches_device
    from skillful_nowcasting_tpu_torch.parallel import make_mesh

    try:
        t0 = time.perf_counter()
        mesh = make_mesh(1, n_space=DP_RANKS, device=dev)
        model = serving_model(torch, dev, output_shape=SPACE_SIZE)
        by_path = {}
        for size, dtypes in ((SPACE_SIZE, (torch.float32, torch.bfloat16)),
                             (SPACE_LARGE, (torch.bfloat16,))):
            # Every rank renders the same global batch (B=1 advecting blobs of 2-12 mm/h, over
            # 12) and draws the same latent: the shared key of JAX's spatial forward.
            ctx, _ = next(synthetic_radar_batches_device(batch_size=1, size=size, seed=19,
                                                         device=dev))
            z = torch.randn((1, 8, size // 32, size // 32),
                            generator=torch.Generator().manual_seed(190))
            for dtype in dtypes:
                name = f"space_{size}_{'bf16' if dtype == torch.bfloat16 else 'f32'}"
                by_path[name] = spatial_case(torch, model, mesh, ctx / 12.0, z, dtype, counters,
                                             say)
        say(f"19 seconds in this rank: {time.perf_counter() - t0:.1f}")
        with open(os.path.join(args.dp_dir, f"rank{rank}.json"), "w") as f:
            json.dump({"launches": by_path}, f)
    finally:
        torch.distributed.destroy_process_group()


def spatial_forward(torch) -> dict:
    """Phase 19b-e: two space ranks of this script on cuda:0 (the kernels are built)."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    results = run_ranks(19, SPACE_TIMEOUT, "space rank")
    return {f"{path}_rank{r}": counts for r, res in enumerate(results)
            for path, counts in res["launches"].items()}


# ---------------------------------------------------------------------------
# 20. The H-sharded train and eval steps on the two ranks of a (data=1, space=2) mesh.
# ---------------------------------------------------------------------------
SPACE_TRAIN_TIMEOUT = 600  # seconds for both ranks together
SPACE_STEP_TOL = 1e-3  # 20b f32, sharded vs dense: each train/* relative, each first-D-update grad
SPACE_EVAL_TOL = 1e-4  # 20b f32 eval metrics, sharded vs dense, relative


def space_tiny_step(torch, dev, mesh, base, x, y, draws) -> dict:
    """One tiny float64 SGD step with R1 on ``dev``: on ``mesh``'s stripes, or the plain step (``None``)."""
    from skillful_nowcasting_tpu_torch import DGMR, training
    from skillful_nowcasting_tpu_torch.parallel import make_dp_train_step, shard_batch

    model = DGMR(**TINY, device=dev)
    model.load_state_dict(base.state_dict())
    model.double()
    g, d = training.split_params(model)
    state = training.init_train_state(
        model, (torch.optim.SGD(g.values(), lr=5e-5), torch.optim.SGD(d.values(), lr=2e-4)))
    if mesh is None:
        m = training.make_train_step(model, return_grads=True, r1_gamma=R1_GAMMA)(
            state, x, y, draws=draws)
    else:
        step = make_dp_train_step(model, mesh, mode="pjit", spatial_axis="space",
                                  return_grads=True, r1_gamma=R1_GAMMA)
        m = step(state, *shard_batch((x, y), mesh, spatial_axis="space"), draws=draws)
    cpu = lambda v: v.detach().to("cpu", torch.float64)  # noqa: E731
    return {"losses": {k: cpu(v).reshape(1) for k, v in m.items() if k.startswith("train/")},
            "g grads": {k: cpu(v) for k, v in m["g_grads"].items()},
            "d grads": {k: cpu(v) for k, v in m["d_grads"].items()},
            "params": {k: cpu(p) for k, p in model.named_parameters()}}


def space_tiny_inputs(torch):
    """20a's seeded weights (desaturated D), B=2 batch and explicit draws, all on the host."""
    from skillful_nowcasting_tpu_torch import DGMR, training
    from skillful_nowcasting_tpu_torch.utils import random_fill

    base = training.desaturate_discriminator(
        random_fill(DGMR(**TINY, device="cpu"), torch.Generator().manual_seed(120)))
    gen = torch.Generator().manual_seed(121)
    x = torch.rand((2, 4, 1, 64, 64), generator=gen).double()
    y = torch.rand((2, 2, 1, 64, 64), generator=gen).double()
    return base, x, y, training.draw_step(base, 6, torch.Generator().manual_seed(122))


def space_tiny_parity(torch, rank, dev, ref_path, say) -> None:
    """20a in a rank: the sharded tiny step on 2 card ranks against 2 CPU ranks and the parent's
    plain step on the card."""
    from skillful_nowcasting_tpu_torch.parallel import make_mesh

    base, x, y, draws = space_tiny_inputs(torch)
    card = space_tiny_step(torch, dev, make_mesh(1, n_space=DP_RANKS, device=dev), base, x, y,
                           draws)
    host = space_tiny_step(torch, "cpu", make_mesh(1, n_space=DP_RANKS, device="cpu"), base, x,
                           y, draws)
    plain = torch.load(ref_path, weights_only=False)
    for what, want in (("2 CPU ranks", host), ("the plain step at B=2 on the card", plain)):
        worst = max(worst_rel(card[g], want[g]) + (g,) for g in want)
        say(f"20a sharded float64 R1 step (2 card ranks, one tiny SGD step, H 32 rows a rank) vs "
            f"{what}: worst {worst[0]:.3e} of the tensor's max-abs at {worst[2]} {worst[1]}")
        if not worst[0] <= TRAIN_TOL:
            fail(f"20a: the sharded step differs from {what} by {worst[0]} > {TRAIN_TOL}")


def span_seconds(log, name: str) -> float:
    """Host seconds of the spans ``name`` in a ``profiling.record()`` log, rounded to 0.1 ms."""
    return round(sum(s["t1_ns"] - s["t0_ns"] for s in log.spans() if s["name"] == name) * 1e-9, 4)


def space_comm(log) -> dict:
    """The halo counters since the last reset and the host seconds of their spans in ``log``:
    (calls, bytes received, host seconds), forward and backward."""
    from skillful_nowcasting_tpu_torch.parallel import halo_exchange, halo_window

    return {"halo_exchange forward": (halo_exchange.calls, halo_exchange.bytes,
                                      span_seconds(log, "dgmr.halo.exchange")),
            "halo_exchange backward": (halo_exchange.backward_calls, halo_exchange.backward_bytes,
                                       span_seconds(log, "dgmr.halo.backward")),
            "halo_window": (halo_window.calls, halo_window.bytes,
                            span_seconds(log, "dgmr.halo.window"))}


def space_train_full_width(torch, rank, dev, counters, say) -> dict:
    """20b: the paper config at 256^2, B=2, on a (data=1, space=2) mesh: an f32 step against the
    dense step, a bf16 R1 step, an f32 eval step against the dense one; rank 0 runs the dense ones."""
    import copy

    import torch.distributed as dist

    from skillful_nowcasting_tpu_torch import DGMR, profiling, training
    from skillful_nowcasting_tpu_torch.parallel import (
        gather_rows,
        make_dp_eval_step,
        make_dp_train_step,
        make_mesh,
        reset_halo_counters,
        shard_batch,
    )
    from skillful_nowcasting_tpu_torch.utils import random_fill

    mesh = make_mesh(1, n_space=DP_RANKS, device=dev)
    base = training.desaturate_discriminator(
        random_fill(DGMR(device=dev), torch.Generator().manual_seed(130)))
    size, steps = base.output_shape, base.forecast_steps
    gen = torch.Generator().manual_seed(131)
    x = torch.rand((2, 4, 1, size, size), generator=gen).to(dev)
    y = torch.rand((2, steps, 1, size, size), generator=gen).to(dev)
    xs, ys = shard_batch((x, y), mesh, spatial_axis="space")

    def sgd(model):
        g, d = training.split_params(model)
        return training.init_train_state(
            model, (torch.optim.SGD(g.values(), lr=5e-5), torch.optim.SGD(d.values(), lr=2e-4)))

    def timed(fn, together=True):
        """``fn()``, its seconds and its peak memory (GiB) above what was allocated before it.

        ``together``: both ranks start it at once (a rank-0-only run does not wait).
        """
        if together:
            dist.barrier()
        torch.cuda.synchronize()
        base_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (out, time.perf_counter() - t0,
                (torch.cuda.max_memory_allocated() - base_bytes) / 2**30)

    def checksum(model):  # every rank's parameters and buffers bit for bit
        rows = gather_rows(bits_checksum(torch, [*model.parameters(), *model.buffers()], dev),
                           mesh.group)
        return bool((rows == rows[0]).all())

    out = {}
    # (i) One f32 step (TF32 off) on stripes, against the dense step of rank 0 on the same draws.
    draws = training.draw_step(base, 4 + steps, torch.Generator().manual_seed(132))
    model = copy.deepcopy(base)
    step = make_dp_train_step(model, mesh, mode="pjit", spatial_axis="space", return_grads=True)
    for counter in counters:
        counter.launches = 0
    reset_halo_counters()
    with profiling.record() as log:
        m, sec, peak = timed(lambda: step(sgd(model), xs, ys, draws=draws))
    comm, launches = space_comm(log), launch_counts(counters)
    equal = checksum(model)
    say(f"20b f32 train step on stripes of {size // DP_RANKS} rows: {sec:.3f} s, peak {peak:.3f} "
        f"GiB above the inputs, launches {launches} (expected 0 each), replicas bit-identical "
        f"{equal}; halo (calls, bytes received, host seconds) {comm} ({SPACE_NOTE})")
    if any(launches.values()) or not equal:
        fail(f"20b f32 step: launches {launches}, replicas equal {equal}")
    if rank == 0:
        dense_model = copy.deepcopy(base)
        dense = training.make_train_step(dense_model, return_grads=True)
        want, dense_sec, dense_peak = timed(lambda: dense(sgd(dense_model), x, y, draws=draws),
                                            together=False)
        losses = {k: abs(m[k].item() - want[k].item()) / abs(want[k].item())
                  for k in want if k.startswith("train/")}
        worst_loss = max((v, k) for k, v in losses.items())
        d_first = worst_rel({k: v[0] for k, v in m["d_grads"].items()},
                            {k: v[0] for k, v in want["d_grads"].items()})
        g_gap = worst_rel(m["g_grads"], want["g_grads"])
        say(f"20b f32 step, sharded vs dense (the same draws, SGD): train/* worst {worst_loss[0]:.3e} "
            f"relative at {worst_loss[1]}, the first D update's gradients worst {d_first[0]:.3e} of "
            f"the tensor's max-abs at {d_first[1]} (limits {SPACE_STEP_TOL}); the G gradients "
            f"{g_gap[0]:.3e} at {g_gap[1]} (no limit: one D/D/G cycle amplifies f32 rounding, "
            f"phase 8's 'train rounding' lines); dense step {dense_sec:.3f} s, peak "
            f"{dense_peak:.3f} GiB above the inputs")
        if len(losses) != 6 or not (worst_loss[0] <= SPACE_STEP_TOL and
                                    d_first[0] <= SPACE_STEP_TOL):
            fail(f"20b f32 sharded step vs dense: losses {losses}, first D grads {d_first}")
        out["g_gap"] = g_gap[0]
        del dense_model, dense, want
    del m
    dist.barrier()
    torch.cuda.empty_cache()

    # (ii) One bf16 step with R1 on stripes (Adam, from the seeded weights: SGD's step above, at
    # the random weights' G gradient norm, leaves G far from them): finite, replicas bit-identical,
    # no kernel launched.
    model = copy.deepcopy(base)
    step = make_dp_train_step(model, mesh, mode="pjit", spatial_axis="space",
                              compute_dtype=torch.bfloat16, r1_gamma=R1_GAMMA)
    for counter in counters:
        counter.launches = 0
    reset_halo_counters()
    with profiling.record() as log:
        m, sec, peak = timed(lambda: step(training.init_train_state(model), xs, ys,
                                          torch.Generator().manual_seed(133)))
    comm, launches = space_comm(log), launch_counts(counters)
    values = {k: v.item() for k, v in m.items()}
    equal = checksum(model)
    say(f"20b bf16 R1 train step on stripes: {sec:.3f} s, peak {peak:.3f} GiB above the inputs, "
        f"d_r1 {values['train/d_r1']:.6e}, launches {launches} (expected 0 each), replicas "
        f"bit-identical {equal}; halo {comm}")
    if not all(math.isfinite(v) for v in values.values()) or any(launches.values()) or not equal:
        fail(f"20b bf16 R1 step: metrics {values}, launches {launches}, replicas equal {equal}")
    del m
    torch.cuda.empty_cache()

    # (iii) One f32 eval step on stripes: 4 / 8 launches a generator forward, on windows.
    ev = make_dp_eval_step(model, mesh, mode="pjit", spatial_axis="space")
    state = training.init_train_state(model)
    forwards = 2 + model.generation_steps
    for counter in counters:
        counter.launches = 0
    reset_halo_counters()
    with profiling.record() as log:
        m, sec, peak = timed(lambda: ev(state, xs, ys, torch.Generator().manual_seed(134)))
    comm, launches = space_comm(log), launch_counts(counters)
    expected = expected_launches(forwards)
    say(f"20b f32 eval step on stripes: {sec:.3f} s, peak {peak:.3f} GiB above the inputs, "
        f"{forwards} generator forwards, launches {launches}, expected {expected}; halo {comm}")
    if launches != expected or not comm["halo_window"][0] > 0:
        fail(f"20b eval step: launches {launches} (expected {expected}), halo {comm}")
    out["launches"] = launches
    if rank == 0:
        want, dense_sec, _ = timed(lambda: training.make_eval_step(model)(
            state, x, y, torch.Generator().manual_seed(134)), together=False)
        errs = {k: abs(m[k].item() - want[k].item()) / abs(want[k].item()) for k in want}
        say(f"20b f32 eval step, sharded vs dense: worst {max(errs.values()):.3e} relative "
            f"(limit {SPACE_EVAL_TOL}); dense {dense_sec:.3f} s")
        if not max(errs.values()) <= SPACE_EVAL_TOL:
            fail(f"20b eval step, sharded vs dense: {errs}")
    dist.barrier()  # rank 1 waits for rank 0's dense step
    return out


def space_trainer_tiny(torch, rank, dev, counters, say) -> dict:
    """20c: ``Trainer(mesh, dp_mode="pjit", spatial_axis="space")`` at the tiny config in f32: two
    steps, the validation at step 2 with the skill metrics (4 / 8 launches a forward, on windows)."""
    import json as json_mod

    from skillful_nowcasting_tpu_torch import DGMR, training
    from skillful_nowcasting_tpu_torch.data import synthetic_radar_batches_device
    from skillful_nowcasting_tpu_torch.parallel import halo_window, make_mesh, reset_halo_counters
    from skillful_nowcasting_tpu_torch.trainer import Trainer
    from skillful_nowcasting_tpu_torch.utils import random_fill

    mesh = make_mesh(1, n_space=DP_RANKS, device=dev)
    model = training.desaturate_discriminator(
        random_fill(DGMR(**TINY, device=dev), torch.Generator().manual_seed(140)))

    def data(seed):  # every rank of the space group reads its data rank's batches
        return synthetic_radar_batches_device(batch_size=2, target_frames=2, size=64, seed=seed,
                                              device=dev)

    with tempfile.TemporaryDirectory(prefix="dgmr_phase20_trainer_") as root:
        trainer = Trainer(model, max_steps=2, log_dir=root, log_every=1, val_every=2,
                          val_skill=True, prefetch=0, seed=141, mesh=mesh, dp_mode="pjit",
                          spatial_axis="space")
        for counter in counters:
            counter.launches = 0
        reset_halo_counters()
        t0 = time.perf_counter()
        state = trainer.fit(data(142), data(143))
        sec = time.perf_counter() - t0
        launches = launch_counts(counters)
        lines = []
        if rank == 0:
            with open(os.path.join(root, "metrics.jsonl")) as f:
                lines = [json_mod.loads(line) for line in f]
    forwards = 2 + model.generation_steps + model.num_samples  # the eval step's, the skill's
    expected = expected_launches(forwards)
    values = [v for line in lines for k, v in line.items() if k != "step"]
    say(f"20c Trainer(mesh=(1, 2), dp_mode='pjit', spatial_axis='space'), tiny, f32: step "
        f"{state.step} in {sec:.3f} s, {len(lines)} logged lines on rank 0, validation launches "
        f"{launches}, expected {expected} ({forwards} forwards), {halo_window.calls} halo windows")
    if state.step != 2 or launches != expected or not halo_window.calls > 0 or (
            rank == 0 and (len(lines) != 3 or not all(math.isfinite(v) for v in values))):
        fail(f"20c sharded Trainer: step {state.step}, launches {launches}, lines {lines}")
    return launches


def space_train_rank_main(args) -> None:
    """One rank of phase 20 (``--dp-rank``, ``--dp-phase 20``): 20a, 20b; writes its results as JSON."""
    torch, rank, dev, counters, say = rank_setup(args, "space train rank")

    try:
        t0 = time.perf_counter()
        space_tiny_parity(torch, rank, dev, args.dp_ref, say)
        t1 = time.perf_counter()
        out = space_train_full_width(torch, rank, dev, counters, say)
        t2 = time.perf_counter()
        out["trainer_launches"] = space_trainer_tiny(torch, rank, dev, counters, say)
        say(f"20 seconds in this rank: a {t1 - t0:.1f}, b {t2 - t1:.1f}, "
            f"c {time.perf_counter() - t2:.1f}")
        with open(os.path.join(args.dp_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        torch.distributed.destroy_process_group()


def space_train(torch, dev, rounding: dict) -> dict:
    """Phase 20: 20a's plain step here on the card, then two space ranks of this script (20a, 20b)."""
    import gc

    base, x, y, draws = space_tiny_inputs(torch)
    plain = space_tiny_step(torch, dev, None, base, x, y, draws)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="dgmr_phase20_ref_") as root:
        ref = os.path.join(root, "plain.pt")
        torch.save(plain, ref)
        results = run_ranks(20, SPACE_TRAIN_TIMEOUT, "space train rank", ["--dp-ref", ref])
    print(f"20b the sharded f32 step's G gradients vs the dense step's: {results[0]['g_gap']:.3e} "
          f"of the tensor's max-abs, beside phase 8's f32 rounding of one tiny step (CPU float32 "
          f"vs float64) {rounding['g grads']:.3e}")
    return {f"space_train_{path}_rank{r}": res[key] for r, res in enumerate(results)
            for path, key in (("eval", "launches"), ("trainer_validation", "trainer_launches"))}


_T0 = time.perf_counter()
_LAST = [_T0]


def stamp(phases: str) -> None:
    """Print the seconds the phases just finished took, and the script's total so far."""
    now = time.perf_counter()
    print(f"time: phases {phases} {now - _LAST[0]:.1f} s, {now - _T0:.1f} s since start")
    _LAST[0] = now


def main() -> None:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile-step", action="store_true",
                        help="only profile one full-width bf16 train step (no checks, no result)")
    parser.add_argument("--dp-rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--dp-port", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--dp-dir", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--dp-phase", type=int, default=17, help=argparse.SUPPRESS)
    parser.add_argument("--dp-ref", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.dp_rank is not None:  # one rank of phase 17, 19 or 20, started by the phase itself
        {17: dp_rank_main, 19: spatial_rank_main, 20: space_train_rank_main}[args.dp_phase](args)
        return

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
            upsample_gblock_fused,
            upsample_gblock_fused_reference,
        )
        from skillful_nowcasting_tpu_torch.utils import random_fill
    except ImportError as e:
        fail(f"the port is not importable (run from the repository root): {e}")
    if args.profile_step:
        profile_step(torch, card)
        return

    # 2. Build.
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc on first use, else the cached library)")
    report = _build.ptxas_report()
    for line in report.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")
    spilled = spills(report)
    sass = sass_counts(_build)
    for label, counts in sass.items():
        print(f"sass {label}: {counts['HGMMA']} HGMMA, {counts['UTMALDG']} UTMALDG, "
              f"{counts['HMMA']} HMMA, spill {spilled.get(label, 'not reported')} bytes")
        if not (counts["HGMMA"] and counts["UTMALDG"]) or counts["HMMA"]:
            fail(f"{label}: wants HGMMA and UTMALDG and no HMMA in its SASS: {counts}")
        if spilled.get(label) != 0:
            fail(f"{label}: ptxas reports {spilled.get(label)} bytes of spill")
    missing = {name for name in KERNEL_FUNCTIONS
               if not any(label.split("<")[0] == name for label in sass)}
    if missing:
        fail(f"kernels missing from the library's SASS: {sorted(missing)}")

    stamp("1-2")
    # 3. Kernels vs plain versions, at the main path's shapes, in f32 and in bf16.
    gen = torch.Generator().manual_seed(0)

    def rand(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)

    results = {}

    def compare(name, fn, ref, args, label, reps, work, kind, bucket=None):
        out, want = fn(*args), ref(*args)
        again = fn(*args)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        tol = KERNEL_TOL if kind == "f32" else KERNEL_TOL_BF16 * scale
        if not torch.equal(out, again):
            fail(f"{name} {label}: two calls on the same inputs gave different bits")
        ms = time_ms(torch, lambda: fn(*args), reps)
        plain_ms = time_ms(torch, lambda: ref(*args), reps)
        ops_ms, bytes_ms = bound(*work, kind)
        bound_ms = max(ops_ms, bytes_ms)
        print(
            f"{name} {label}: max_abs_err {err:.3e} ({err / max(scale, 1e-30):.3e} of max|plain|, "
            f"limit {tol:.3e}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({'operations' if ops_ms >= bytes_ms else 'bytes'}), "
            f"{work[0] / ms / 1e9:.2f} TFLOP/s, {100 * bound_ms / ms:.1f}% of bound, "
            f"{work[0] / 1e9:.2f} GFLOP, {work[1] / 1e6:.1f} MB"
        )
        if not err <= tol:
            fail(f"{name} {label}: kernel differs from its plain version by {err} > {tol}")
        r = results.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                      "bound_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0,
                                      "peak": PEAK_NAME[kind], "library_ms": None})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if bucket is not None:
            r = r.setdefault(bucket, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                      "bound_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0})
            r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["bound_ms"] += bound_ms
        r["ops_ms"] += ops_ms
        r["bytes_ms"] += bytes_ms

    def gru_case(t_in, batch, h, w, c, dtype):
        """A rollout's arguments: gx, h0, the hidden-part kernels, bias, steps."""
        s = (9 * c) ** -0.5  # gates stay away from saturation
        return (
            rand(t_in, batch, h, w, 3 * c, dtype=dtype),
            rand(batch, h, w, c, dtype=dtype),
            rand(3, 3, c, 2 * c, scale=s, dtype=dtype),
            rand(3, 3, c, c, scale=s, dtype=dtype),
            rand(3 * c, scale=0.1, dtype=dtype),
            steps,
        )

    def gblock_case(n, h, w, cin, cout, dtype):
        """An eval GBlock's arguments: x, the three kernels, the f32 affines, the shortcut flag."""
        return (
            rand(n, h, w, cin, dtype=dtype),
            rand(3, 3, cin, cin, scale=(9 * cin) ** -0.5, dtype=dtype),
            rand(3, 3, cin, cout, scale=(9 * cin) ** -0.5, dtype=dtype),
            rand(1, 1, cin, cout, scale=cin ** -0.5, dtype=dtype),
            1.0 + rand(cin, scale=0.1),
            rand(cin, scale=0.1),
            1.0 + rand(cin, scale=0.1),
            rand(cin, scale=0.1),
            rand(cout, scale=0.1),
            cin != cout,
        )

    # The serving request's batch (B=2) and the tile batch of tiled_nowcast_device (B=16 tiles,
    # so N = 16 x 18 GBlock rows): the GRU's split-K plan depends on M = B H W. bf16 takes the
    # same shapes, all operands bf16 but the GBlock's f32 affines.
    steps = 18
    kinds = (("f32", torch.float32, 4), ("bf16", torch.bfloat16, 2))  # kind, dtype, bytes
    for kind, dtype, elem in kinds:
        suffix = "" if kind == "f32" else "_bf16"
        for batch, reps, bucket in ((2, 20, None), (TILE_BATCH, 5, f"tile_batch_{TILE_BATCH}")):
            for t_in, hw, c in ((1, 8, 384), (steps, 16, 192), (steps, 32, 96), (steps, 64, 48)):
                args = gru_case(t_in, batch, hw, hw, c, dtype)
                compare(f"convgru_rollout{suffix}", convgru_rollout, convgru_rollout_reference,
                        args, f"T={steps} gx={tuple(args[0].shape)}", reps=reps,
                        work=gru_work(t_in, batch, hw, c, steps, elem), kind=kind, bucket=bucket)

            n = steps * batch
            for hw, cin, cout in ((8, 768, 768), (16, 384, 384), (32, 192, 192), (64, 96, 96),
                                  (16, 384, 192)):
                args = gblock_case(n, hw, hw, cin, cout, dtype)
                compare(f"gblock_fused{suffix}", gblock_fused, gblock_fused_reference, args,
                        f"x={tuple(args[0].shape)} cout={cout}", reps=reps,
                        work=gblock_work(n, hw, cin, cout, elem), kind=kind, bucket=bucket)
                # NHWC memory viewed as NCHW is channels_last.
                xc = args[0].permute(0, 3, 1, 2)
                w1, w2 = (k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                          for k in args[1:3])
                conv = torch.nn.functional.conv2d
                yard = time_ms(torch, lambda: conv(conv(xc, w1, padding=1), w2, padding=1), reps)
                print(f"gblock_fused{suffix} x={tuple(args[0].shape)} cout={cout}: conv "
                      f"yardstick (cuDNN {kind} F.conv2d{', TF32 off' if kind == 'f32' else ''}, "
                      f"channels_last, the block's two 3x3 convs, no affine or shortcut) "
                      f"{yard:.4f} ms")
                del args
            # The UpsampleGBlocks: x at half the output's side, Cout = Cin / 2.
            for hw, cin in ((8, 768), (16, 384), (32, 192), (64, 96)):
                args = gblock_case(n, hw, hw, cin, cin // 2, dtype)[:-1]
                compare(f"upsample_gblock_fused{suffix}", upsample_gblock_fused,
                        upsample_gblock_fused_reference, args,
                        f"x={tuple(args[0].shape)} cout={cin // 2}", reps=reps,
                        work=upsample_gblock_work(n, hw, cin, cin // 2, elem), kind=kind,
                        bucket=bucket)
                xc = args[0].permute(0, 3, 1, 2)
                w1, w2, wsc = (k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                               for k in args[1:4])
                conv = torch.nn.functional.conv2d

                def eager():
                    up = torch.nn.functional.interpolate(xc, scale_factor=2, mode="nearest")
                    return conv(conv(up, w1, padding=1), w2, padding=1) + conv(up, wsc)

                yard = time_ms(torch, eager, reps)
                print(f"upsample_gblock_fused{suffix} x={tuple(args[0].shape)} cout={cin // 2}: "
                      f"cuDNN {kind}{' (TF32 off)' if kind == 'f32' else ''} of the eager block's "
                      f"upsample, two 3x3 convs and 1x1 shortcut (channels_last, no affine) "
                      f"{yard:.4f} ms")
                del args
    f32_against_before(results, ("batch_2", f"tile_batch_{TILE_BATCH}"))
    torch.cuda.empty_cache()

    stamp("3")
    # 4. The slice at full width through make_generate, from a CPU batch.
    batch = 2
    model = serving_model(torch, dev)
    s_n, fs, size = model.num_samples, model.forecast_steps, model.output_shape
    generate = make_generate(model)
    x = torch.rand((batch, 4, 1, size, size), generator=torch.Generator().manual_seed(3))

    counters = (Counter(convgru_rollout, "launches", "convgru_rollout"),
                Counter(gblock_fused, "launches", "gblock_fused"),
                Counter(convgru_rollout, "launches_bf16", "convgru_rollout_bf16"),
                Counter(gblock_fused, "launches_bf16", "gblock_fused_bf16"))
    for counter in counters:
        counter.launches = 0
    upsample_gblock_fused.launches = upsample_gblock_fused.launches_bf16 = 0
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
    launches = launch_counts(counters)
    forwards = REQUESTS * s_n
    expected = expected_launches(forwards)
    launches["upsample_gblock_fused"] = upsample_gblock_fused.launches
    launches["upsample_gblock_fused_bf16"] = upsample_gblock_fused.launches_bf16
    expected.update(upsample_gblock_fused=8 * forwards, upsample_gblock_fused_bf16=0)
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

    stamp("4-6")
    # 7. Training at full width; 8. training parity, card vs CPU.
    by_path = train_full_width(torch, dev, card, counters)
    rounding = train_parity(torch, dev)

    stamp("7-8")
    # 9-12. The serving user's paths at full width; 13. their parity, card vs CPU.
    model = serving_model(torch, dev)
    by_path.update(hub_round_trips(torch, dev, model, card, counters))
    by_path.update(tiled_field(torch, dev, model, card, counters))
    by_path.update(mrms_field(torch, model, card, counters))
    by_path.update(skill_eval(torch, model, card, counters))
    torch.cuda.empty_cache()
    serving_parity_tiny(torch, dev)

    stamp("9-13")
    # 14. The serving artifact at full width; 15. the bf16 serving config at full width.
    by_path.update(artifact_full_width(torch, dev, model, card, counters))
    bf16_launches, more = bf16_full_width(torch, dev, model, card, counters)
    by_path.update(more)
    del model
    torch.cuda.empty_cache()

    stamp("14-15")
    # 16. The retraining path at full width: bf16 steps, R1, watch, Trainer killed and resumed.
    by_path.update(retrain_full_width(torch, dev, card, counters))

    stamp("16")
    # 17. Data parallelism on one card: two gloo ranks (tiny parity, Trainer, tilers), NCCL of one.
    by_path.update(data_parallel(torch, dev, card))

    stamp("17")
    # 18. A full-width nowcast scored by every ported loss, card vs CPU; coord conv; its refusal.
    by_path.update(score_nowcast(torch, dev, card, counters))

    stamp("18")
    # 19. The generator forward H-sharded over two space ranks: (a) here, both kernels alone on
    # the windows that layout hands them at 512^2; (b)-(e) in two ranks on cuda:0.
    # Each window is cut from a whole level's operands: the first rank's (the top rows) is held
    # against the plain version and timed; both ranks' stripes must equal the same rows of the
    # kernel on the whole level, bit for bit (the kernels do not depend on a window's offset).
    def window_of(name, whole, lo, n):  # the operands of rows lo:lo+n of a whole level
        if name == "gru":  # gx (T, B, H, W, 3C), h0 (B, H, W, C)
            return (whole[0][:, :, lo:lo + n].contiguous(), whole[1][:, lo:lo + n].contiguous(),
                    *whole[2:])
        return (whole[0][:, lo:lo + n].contiguous(), *whole[1:])  # x (N, H, W, Cin)

    def windows_exact(name, fn, whole, window, stripe):
        rows, axis = whole[1 if name == "gru" else 0].shape[1], 2 if name == "gru" else 1
        full = fn(*whole)
        for lo, keep in ((0, 0), (rows - window, window - stripe)):
            got = fn(*window_of(name, whole, lo, window)).narrow(axis, keep, stripe)
            if not torch.equal(got, full.narrow(axis, lo + keep, stripe)):
                fail(f"19a {name} window rows {lo}:{lo + window} of {rows}: its stripe differs "
                     "from the kernel on the whole level")

    for kind, dtype, elem in kinds:
        suffix = "" if kind == "f32" else "_bf16"
        for level, (rows, stripe, gru_rows, gb_rows) in enumerate(space_levels(SPACE_SIZE, steps)):
            c, t_in = 384 >> level, 1 if level == 0 else steps
            whole = gru_case(t_in, 1, rows, rows, c, dtype)
            args = window_of("gru", whole, 0, gru_rows)
            compare(f"convgru_rollout{suffix}", convgru_rollout, convgru_rollout_reference, args,
                    f"space window of a {stripe}-row stripe, T={steps} gx={tuple(args[0].shape)}",
                    reps=5, work=gru_work(t_in, 1, (gru_rows, rows), c, steps, elem), kind=kind,
                    bucket=SPACE_BUCKET)
            windows_exact("gru", convgru_rollout, whole, gru_rows, stripe)
            cin = 768 >> level
            whole = gblock_case(steps, rows, rows, cin, cin, dtype)
            args = window_of("gblock", whole, 0, gb_rows)
            compare(f"gblock_fused{suffix}", gblock_fused, gblock_fused_reference, args,
                    f"space window of a {stripe}-row stripe, x={tuple(args[0].shape)} cout={cin}",
                    reps=5, work=gblock_work(steps, (gb_rows, rows), cin, cin, elem), kind=kind,
                    bucket=SPACE_BUCKET)
            windows_exact("gblock", gblock_fused, whole, gb_rows, stripe)
            del whole, args
    print("19a: every window's stripe equals the kernel on the whole level, bit for bit, f32 and "
          "bf16, both ranks")
    f32_against_before(results, (SPACE_BUCKET,))
    torch.cuda.empty_cache()
    by_path.update(spatial_forward(torch))

    stamp("19")
    # 20. The H-sharded train and eval steps: (a) the tiny float64 R1 step's plain reference here,
    # then two space ranks of this script on cuda:0: (a) that step on stripes, card and CPU ranks;
    # (b) the paper config at 256^2: f32 and bf16 R1 train steps and an f32 eval step.
    by_path.update(space_train(torch, dev, rounding))

    stamp("20")
    # 21. The JAX package's Orbax checkpoint at full width: written by the port, restored bit for
    # bit, the next train step and the eval step (both f32 kernels) equal, a Trainer resumed.
    by_path.update(orbax_full_width(torch, card, counters))

    stamp("21")
    gru = ("skillful_nowcasting_tpu_torch/csrc/gru_rollout.cu",
           "skillful_nowcasting_tpu/ops/pallas_gru.py:40")
    gblock = ("skillful_nowcasting_tpu_torch/csrc/gblock_fused.cu",
              "skillful_nowcasting_tpu/ops/pallas_gblock.py:66")
    # Each variant's main path: the f32 requests of phase 4, the bf16 requests of phase 15.
    # The UpsampleGBlock has no Pallas kernel: its op runs the GBlock kernel's bodies.
    main_path = {"convgru_rollout": (gru, launches), "gblock_fused": (gblock, launches),
                 "upsample_gblock_fused": (gblock, launches),
                 "convgru_rollout_bf16": (gru, bf16_launches),
                 "gblock_fused_bf16": (gblock, bf16_launches),
                 "upsample_gblock_fused_bf16": (gblock, bf16_launches)}
    by_path = {"serve": launches, **by_path, "serve_bf16": bf16_launches}
    kernels = []
    for name, ((src, rep), counts) in main_path.items():
        r = dict(results[name])
        r["bound_by"] = "operations" if r.pop("ops_ms") >= r.pop("bytes_ms") else "bytes"
        for bucket in r.values():
            if isinstance(bucket, dict):
                bucket["bound_by"] = ("operations" if bucket.pop("ops_ms") >= bucket.pop("bytes_ms")
                                      else "bytes")
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": counts[name], **r,
            "launches_by_path": {p: c[name] for p, c in by_path.items() if name in c},
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
