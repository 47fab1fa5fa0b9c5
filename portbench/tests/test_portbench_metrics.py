"""Each metric reader on a trace written by hand, and the parsing of a real (CPU) profile."""

from __future__ import annotations

import json

import pytest
import torch

from portbench.harness.runner import Reading
from portbench.harness.spec import BENCH, load_cell, reader
from portbench.harness.trace import WINDOW, Event, Trace, record
from portbench.work import dgmr_forward, gblock_fused, gru_rollout

MS = 1e-3
GRU = "void dgmr::gru_rollout_kernel<16>(CUtensorMap_st, ...)"
GBLOCK = "void dgmr::gblock_conv1_kernel(CUtensorMap_st, ...)"
CONV = "sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc"
EW = "void at::native::elementwise_kernel<128, 4, ...>"


def config(name="dgmr-256-f32"):
    with open(BENCH / "configs" / f"{name}.json") as f:
        return json.load(f)


def trace(with_port=True) -> Trace:
    """A 100 ms window: kernels 0-10, 12-30 (two overlapping), 40-50 ms, a memcpy 60-70 ms."""
    ev = [Event(WINDOW, "host", 0.0, 100 * MS),
          Event("aten::conv2d", "host", 30 * MS, 41 * MS),
          Event("cudaHostAlloc", "host", 75 * MS, 99 * MS),
          Event(CONV, "kernel", 0.0, 10 * MS),
          Event(EW, "kernel", 12 * MS, 20 * MS),
          Event(CONV, "kernel", 15 * MS, 30 * MS),
          Event("Memcpy HtoD (Pageable -> Device)", "memcpy", 60 * MS, 70 * MS)]
    if with_port:
        ev += [Event(GRU, "kernel", 40 * MS, 45 * MS), Event(GBLOCK, "kernel", 45 * MS, 50 * MS)]
    return Trace.from_events(ev)


def reading(tr=None, answers=2, cfg=None) -> Reading:
    return Reading(cfg or config(), setup_s=31.5, answers=answers, window_s=4.0,
                   latencies=[1.0, 3.0, 2.0], frames=216, forwards=[2] * 6,
                   least_work={"context": 2, "latent": 6, "sampler": 12}, trace=tr)


def read(name, r):
    return reader(name)(r)


def test_trace_busy_and_gaps():
    tr = trace()
    assert tr.window_s == pytest.approx(0.1)
    assert tr.busy_s == pytest.approx(0.048)  # 0-10, 12-30, 40-50 and the memcpy 60-70
    assert tr.idle_gaps() == pytest.approx([(0.010, 0.012), (0.030, 0.040), (0.050, 0.060),
                                            (0.070, 0.100)])
    b = tr.breakdown()
    assert b["device_ops"][0] == [CONV, pytest.approx(0.025)]
    assert dict(b["idle_gaps"]) == pytest.approx({"cudaHostAlloc": 0.030, "aten::conv2d": 0.010,
                                                  WINDOW: 0.012})


def test_end_to_end_readers():
    r = reading()
    assert read("frames_per_s", r) == pytest.approx(2 * 216 / 4.0)
    assert read("field_s", r) == pytest.approx(2.0)
    assert read("setup_s", r) == 31.5
    assert read("frames_per_s", reading(answers=0)) is None


def test_trace_readers():
    r = reading(trace())
    assert read("request_p50_ms.frames", r) == pytest.approx(2000.0)
    assert read("memcpy_ms.field", r) == pytest.approx(10.0 / 2)
    assert read("launches.frames", r) == 5 / 2
    assert read("conv_ms.frames", r) == pytest.approx(25.0 / 2)  # the port's kernels left out
    assert read("idle_share.field", r) == pytest.approx(52.0)
    cfg = r.config
    least = sum(max(f / 495e12, b / 3.35e12) for f, b in gru_rollout.work(cfg, 2, 4)) * 6
    assert read("gru_roofline.frames", r) == pytest.approx(100 * 2 * least / 5e-3)
    least = sum(max(f / 495e12, b / 3.35e12) for f, b in gblock_fused.work(cfg, 2, 4)) * 6
    assert read("gblock_roofline.field", r) == pytest.approx(100 * 2 * least / 5e-3)
    flops = (2 * dgmr_forward.context(cfg) + 6 * dgmr_forward.latent(cfg)
             + 12 * dgmr_forward.sampler(cfg))
    assert read("mfu.frames", r) == pytest.approx(100 * 2 * flops / 0.1 / 495e12)


def test_bf16_rooflines_use_its_peak_and_element():
    r = reading(trace(), cfg=config("dgmr-256-bf16"))
    assert r.elem == 2
    least = sum(max(f / 989e12, b / 3.35e12) for f, b in gru_rollout.work(r.config, 2, 2)) * 6
    assert read("gru_roofline.field", r) == pytest.approx(100 * 2 * least / 5e-3)


@pytest.mark.parametrize("name", ["gru_roofline.frames", "gblock_roofline.field"])
def test_a_kernel_absent_reads_nothing(name):
    assert read(name, reading(trace(with_port=False))) is None


@pytest.mark.parametrize("name", ["memcpy_ms.field", "launches.frames", "conv_ms.field",
                                  "idle_share.frames", "mfu.field", "gru_roofline.field"])
def test_untraced_reads_nothing(name):
    assert read(name, reading(None)) is None


def test_every_metric_has_a_reader():
    for name in ("ens.f32.b2", "conus.bf16"):
        cell = load_cell(name)
        for m in cell.end_to_end + cell.per_layer:
            assert callable(reader(m["name"]))


def test_record_parses_a_real_profile():
    a = torch.randn(64, 64)
    result, tr = record(lambda: (a @ a).sum(), cuda=False)
    assert result.shape == () and tr.window_s > 0
    assert any(e.name == "aten::mm" for e in tr.host)
    assert tr.device == [] and tr.busy_s == 0


class _Raw:
    """A profiler record of a torch build without ``activity_type``."""

    def __init__(self, name, device, annotation=False):
        self._name, self._device, self._annotation = name, device, annotation

    def name(self):
        return self._name

    def device_type(self):
        return f"DeviceType.{self._device}"

    def is_user_annotation(self):
        return self._annotation


@pytest.mark.parametrize("raw, kind", [
    (_Raw("aten::conv2d", "CPU"), "host"),
    (_Raw(WINDOW, "CPU", annotation=True), "host"),
    (_Raw(WINDOW, "CUDA", annotation=True), None),  # the annotation's copy on the device timeline
    (_Raw("Memcpy DtoH (Device -> Pinned)", "CUDA"), "memcpy"),
    (_Raw("Memset (Device)", "CUDA"), "memset"),
    (_Raw(GRU, "CUDA"), "kernel"),
])
def test_records_are_told_apart_without_activity_types(raw, kind):
    from portbench.harness.trace import _kind

    assert _kind(raw) == kind
