"""The work functions against FLOPs and bytes worked out by hand, and against a FLOP counter."""

from __future__ import annotations

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.harness.spec import BENCH
from portbench.harness.weights import make_state_dict
from portbench.reference.dgmr import Reference
from portbench.reference.schema import generator_schema
from portbench.tests.tiny import TINY_MODEL
from portbench.work import dgmr_forward, gblock_fused, gru_rollout


def test_gru_rollout_by_hand():
    # 18 steps at B=2 on 8x8 x 384: each step 2 * 128 px * 9 * 384 in * 1152 out.
    flops, nbytes = gru_rollout.rollout(1, 2, 8, 384, 18, 4)
    assert flops == 18 * 2 * 128 * 9 * 384 * 1152
    weights, bias, gx, h0, outs = 9 * 384 * 1152, 1152, 128 * 1152, 128 * 384, 18 * 128 * 384
    assert nbytes == 4 * (weights + bias + gx + h0 + outs)
    levels = gru_rollout.work({"forecast_steps": 18, "output_shape": 256,
                               "context_channels": 384}, 2, 2)
    assert levels[0] == gru_rollout.rollout(1, 2, 8, 384, 18, 2)
    assert levels[3] == gru_rollout.rollout(18, 2, 64, 48, 18, 2)  # input part once a step


def test_gblock_by_hand():
    # 36 frames of 8x8 x 768: two 3x3 convs 768 -> 768, no shortcut conv.
    flops, nbytes = gblock_fused.gblock(36, 8, 768, 768, 2)
    m = 36 * 64
    assert flops == 2 * 2 * m * 9 * 768 * 768
    assert nbytes == 2 * (2 * m * 768 + 2 * 9 * 768 * 768) + 4 * 5 * 768
    sc_flops, _ = gblock_fused.gblock(1, 4, 8, 16, 4)
    assert sc_flops == 2 * 16 * 9 * 8 * 24 + 2 * 16 * 8 * 16
    levels = gblock_fused.work({"forecast_steps": 18, "output_shape": 256,
                                "latent_channels": 768}, 2, 2)
    assert levels[0] == (flops, nbytes) and len(levels) == 4


def test_published_sample_forward():
    """Half a TFLOP a 256-square sample: within 15% of the XLA cost analysis of the JAX package."""
    with open(BENCH / "configs" / "dgmr-256-f32.json") as f:
        cfg = json.load(f)
    total = dgmr_forward.context(cfg) + dgmr_forward.latent(cfg) + dgmr_forward.sampler(cfg)
    assert total == pytest.approx(0.504e12, rel=1e-3)
    assert abs(total / 0.4475e12 - 1) < 0.15  # 7.16 TFLOP per B=16 forward, by XLA


def _counted(fn) -> float:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def test_against_a_flop_counter_on_the_reference():
    cfg = dict(TINY_MODEL, input_channels=1)
    ref = Reference(make_state_dict(generator_schema(cfg), 1, "cpu"), cfg["forecast_steps"])
    x = torch.rand((1, 4, 1, 64, 64))
    z = torch.randn((1, 8, 2, 2))
    assert _counted(lambda: ref.context(x)) == dgmr_forward.context(cfg)
    assert _counted(lambda: ref.latent(z)) == dgmr_forward.latent(cfg)
    states, lat = ref.context(x), ref.latent(z)
    # The plain sampler recomputes the bottom level's input part at every step; the least work
    # counts it once.
    g, lc, cc, t = 2, cfg["latent_channels"], cfg["context_channels"], cfg["forecast_steps"]
    repeat = (t - 1) * 3 * dgmr_forward.conv(g, lc, cc, 3)
    assert _counted(lambda: ref.sampler(states, lat)) == dgmr_forward.sampler(cfg) + repeat
