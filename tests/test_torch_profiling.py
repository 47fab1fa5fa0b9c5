"""The port's spans (``profiling.span``): off unless recorded, nested per request, on the profiler's clock.

A tiny eval DGMR on the CPU (no JAX): nothing is recorded and
``record_function`` is never called while neither a profiler nor
``profiling.record()`` runs; under ``record()`` the spans nest as the
layers do and one request id covers a ``generate`` call; the derivation
spans count the model's spectral norms, GBlocks, UpsampleGBlocks and
rollouts; under a CPU ``torch.profiler`` every span is also one of its
records, on the same clock; the log is a bounded ring; and the artifact
still exports with spans inside its forward.
"""

from __future__ import annotations

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from skillful_nowcasting_tpu_torch import DGMR, profiling, serving
from skillful_nowcasting_tpu_torch.inference import make_generate
from skillful_nowcasting_tpu_torch.layers.convgru import ConvGRU
from skillful_nowcasting_tpu_torch.models.common import GBlock, UpsampleGBlock
from skillful_nowcasting_tpu_torch.ops.spectral_norm import SpectralNorm

TINY = dict(forecast_steps=2, output_shape=64, latent_channels=256, context_channels=32,
            num_samples=2)
CLOCK_NS = 50_000  # a span's stamps against its profiler record's


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return DGMR(**TINY, device="cpu").eval()


@pytest.fixture
def x():
    return torch.rand((1, 4, 1, 64, 64), generator=torch.Generator().manual_seed(1))


def parents(spans):
    by_id = {s["id"]: s for s in spans}
    return {s["id"]: by_id.get(s["parent"]) for s in spans}


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def test_off_records_nothing(model, x, monkeypatch):
    calls = []
    monkeypatch.setattr(profiling, "record_function", lambda name: calls.append(name))
    profiling.LOG.clear()
    out = make_generate(model)(x, torch.Generator().manual_seed(2))
    assert out.shape == (2, 1, 2, 1, 64, 64)
    assert calls == [] and len(profiling.LOG) == 0
    # One shared context, whatever the span: no allocation, no torch op.
    assert profiling.span("a", device=x) is profiling.span("b", entry=True)
    assert profiling.annotate is profiling.span
    with _Ops() as seen:
        with profiling.span("dgmr.forward", device=x):
            pass
    assert seen.ops == []


def test_spans_nest_and_share_a_request(model, x):
    generate = make_generate(model)
    with profiling.record() as log:
        generate(x, torch.Generator().manual_seed(2))
        generate(x, torch.Generator().manual_seed(3))
        model(x)  # a bare forward: a request of its own
    spans = log.spans()
    up = parents(spans)
    roots = [s for s in spans if up[s["id"]] is None]
    assert [s["name"] for s in roots] == ["dgmr.generate", "dgmr.generate", "dgmr.forward"]
    assert len({s["request"] for s in roots}) == 3

    def root(s):
        while up[s["id"]] is not None:
            s = up[s["id"]]
        return s

    want = {"dgmr.forward": ("dgmr.generate", None), "dgmr.context": ("dgmr.forward",),
            "dgmr.latent": ("dgmr.forward",), "dgmr.sampler": ("dgmr.forward",),
            "dgmr.convgru": ("dgmr.sampler",), "dgmr.upsample_gblock": ("dgmr.sampler",),
            "dgmr.derive.rollout": ("dgmr.convgru",), "dgmr.derive.gblock": ("dgmr.sampler",),
            "dgmr.derive.upsample_gblock": ("dgmr.upsample_gblock",)}
    for s in spans:
        p = up[s["id"]]
        assert s["request"] == root(s)["request"]
        assert s["thread"] == roots[0]["thread"] and s["stream_ms"] is None
        if s["name"] in want:
            assert (p["name"] if p else None) in want[s["name"]], s
        if p is not None:
            assert p["t0_ns"] <= s["t0_ns"] <= s["t1_ns"] <= p["t1_ns"]
    per_request = {}
    for s in spans:
        if s["name"] == "dgmr.forward":
            per_request[s["request"]] = per_request.get(s["request"], 0) + 1
    assert sorted(per_request.values()) == [1, TINY["num_samples"], TINY["num_samples"]]


def test_derive_spans_count_the_models_derivations(model, x):
    with profiling.record() as log:
        model(x)
    names = [s["name"] for s in log.spans()]
    mods = [m for stack in (model.conditioning_stack, model.latent_stack, model.sampler)
            for m in stack.modules()]
    assert names.count("dgmr.derive.sn") == sum(isinstance(m, SpectralNorm) for m in mods) == 58
    assert names.count("dgmr.derive.gblock") == sum(isinstance(m, GBlock) for m in mods) == 4
    assert names.count("dgmr.derive.upsample_gblock") == sum(
        isinstance(m, UpsampleGBlock) for m in mods) == 4
    assert names.count("dgmr.derive.rollout") == sum(isinstance(m, ConvGRU) for m in mods) == 4


def test_spans_are_profiler_records_on_its_clock(model, x):
    """Each span is one of the profiler's records, its stamps within 50 µs of the record's.

    A clock apart would move every span; a host thread preempted between the
    record's stamp and the span's own moves one, so nine in ten must hold.
    """
    profiling.LOG.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model(x)
    logged = profiling.spans()
    marks = sorted((e for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("dgmr.")), key=lambda e: e.start_ns())
    assert len(logged) > 60
    assert [e.name() for e in marks] == [s["name"] for s in logged]
    near = [abs(e.start_ns() - s["t0_ns"]) <= CLOCK_NS
            and abs(e.start_ns() + e.duration_ns() - s["t1_ns"]) <= CLOCK_NS
            for e, s in zip(marks, logged)]
    assert sum(near) >= 0.9 * len(near), sum(near)
    profiling.LOG.clear()


def test_the_ring_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(profiling, "CAPACITY", 8)
    with profiling.record() as log:
        for i in range(20):
            with profiling.span(f"s{i}"):
                pass
    assert len(log) == 8 and log.dropped == 12
    assert [s["name"] for s in log.spans()] == [f"s{i}" for i in range(12, 20)]


def test_write_gives_json_lines(tmp_path):
    with profiling.record(device=True) as log:
        with profiling.annotate("outer", entry=True):
            with profiling.span("inner", device=torch.ones(1)):  # a CPU tensor: no events
                pass
    assert log.write(str(tmp_path / "spans.jsonl")) == 2
    with open(tmp_path / "spans.jsonl") as f:
        outer, inner = (json.loads(line) for line in f)
    assert set(outer) == {"name", "id", "parent", "request", "thread", "t0_ns", "t1_ns",
                          "stream_ms"}
    assert (outer["name"], inner["name"]) == ("outer", "inner")
    assert inner["parent"] == outer["id"] and inner["request"] == outer["request"]
    assert inner["stream_ms"] is None and outer["t0_ns"] <= inner["t0_ns"]
    assert [s["name"] for s in log.spans(inner["t0_ns"], inner["t1_ns"])] == ["inner"]


def test_the_artifact_exports_with_spans_recording(model, x):
    with profiling.record() as log:
        program, _, weights = serving.export_nowcast(model, batch_size=1, num_samples=1)
    assert len(log) == 0  # a graph being traced records nothing
    assert "profiler" not in program.graph_module.code
    z = torch.randn((1, *model.latent_stack.shape), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        assert torch.equal(program.module()(x, z, weights), model(x, z=z))
