"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Both kernels in f32 (3xTF32 wgmma + TMA; tolerance 1e-5 at small widths,
1e-4 at the main path's) and in bf16 (2^-7 of the largest plain output,
one bf16 ulp there), a tiny serving artifact on the card, and the losses and
``CoordConv`` on the card against the same on the CPU.

Every test here is marked ``cuda`` and skips where CUDA is absent. The file
imports neither JAX nor the JAX package, so it also runs on a GPU machine
without them (``tests/conftest.py`` imports JAX, hence ``--noconftest``):

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py
"""

import ctypes

import numpy as np
import pytest
import torch

from skillful_nowcasting_tpu_torch import DGMR, _build, serving, training
from skillful_nowcasting_tpu_torch.inference import (
    evaluate_nowcast,
    make_generate,
    tiled_nowcast,
    tiled_nowcast_device,
)
from skillful_nowcasting_tpu_torch.ops import (
    convgru_rollout,
    convgru_rollout_reference,
    gblock_fused,
    gblock_fused_reference,
)
from skillful_nowcasting_tpu_torch.utils import random_fill

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    """The first CUDA device with f32 convs (TF32 off).

    Decided at run time, so every xdist worker collects the same tests.
    """
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def randn(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def gru_inputs(rng, t_in, b, hw, c, dev):
    s = (9 * c) ** -0.5
    shapes = [(t_in, b, hw, hw, 3 * c), (b, hw, hw, c), (3, 3, c, 2 * c), (3, 3, c, c), (3 * c,)]
    scales = [1.0, 1.0, s, s, 0.1]
    return [randn(rng, *shape, scale=sc).to(dev) for shape, sc in zip(shapes, scales)]


# Ragged channel counts (the wrapper pads them to multiples of 16), a
# multiple of 16 that is no multiple of 32 (a half-empty last chunk), and the
# Sampler's 8x8 / C=384 level at B=1: the fewest pixels, so the most split-K.
# Tolerance 1e-5, and 1e-4 (the main path's) at full width.
@pytest.mark.parametrize(
    "t_in,b,hw,c,tol",
    [(3, 2, 5, 6, 1e-5), (1, 2, 8, 70, 1e-5), (3, 3, 9, 40, 1e-5), (3, 2, 12, 48, 1e-5),
     (1, 1, 8, 384, 1e-4)],
)
def test_convgru_rollout_kernel_matches_plain(dev, t_in, b, hw, c, tol):
    steps = 3
    args = gru_inputs(np.random.default_rng(0), t_in, b, hw, c, dev)
    before = convgru_rollout.launches
    got = convgru_rollout(*args, n_steps=steps)
    assert convgru_rollout.launches - before == 1  # one persistent launch per rollout
    want = convgru_rollout_reference(*args, n_steps=steps)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= tol


def gblock_inputs(rng, n, h, w, cin, cout, dev):
    shapes = [(n, h, w, cin), (3, 3, cin, cin), (3, 3, cin, cout), (1, 1, cin, cout)]
    scales = [1.0, (9 * cin) ** -0.5, (9 * cin) ** -0.5, cin**-0.5]
    args = [randn(rng, *shape, scale=sc).to(dev) for shape, sc in zip(shapes, scales)]
    return args + [randn(rng, cin).to(dev) for _ in range(4)] + [randn(rng, cout).to(dev), cin != cout]


@pytest.mark.parametrize(
    "n,h,w,cin,cout",
    [(2, 7, 5, 6, 6), (3, 8, 9, 20, 12), (2, 6, 6, 70, 70), (4, 8, 8, 128, 128), (4, 9, 7, 96, 64)],
)
def test_gblock_fused_kernel_matches_plain(dev, n, h, w, cin, cout):
    args = gblock_inputs(np.random.default_rng(1), n, h, w, cin, cout, dev)
    before = gblock_fused.launches
    got = gblock_fused(*args)
    assert gblock_fused.launches - before == 2
    want = gblock_fused_reference(*args)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5


# The tile batch of tiled_nowcast_device: 16 tiles a forward, so the GRU runs
# at B=16 (M = 16 H W, another split-K plan) and the GBlock at N = 16 x 18.
@pytest.mark.parametrize("hw,c", [(8, 384), (16, 192), (32, 96), (64, 48)])
def test_convgru_rollout_kernel_at_the_tile_batch(dev, hw, c):
    args = gru_inputs(np.random.default_rng(5), 1 if c == 384 else 3, 16, hw, c, dev)
    got = convgru_rollout(*args, n_steps=3)
    want = convgru_rollout_reference(*args, n_steps=3)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4
    assert torch.equal(got, convgru_rollout(*args, n_steps=3))


@pytest.mark.parametrize(
    "hw,cin,cout", [(8, 768, 768), (16, 384, 384), (32, 192, 192), (64, 96, 96), (16, 384, 192)]
)
def test_gblock_fused_kernel_at_the_tile_batch(dev, hw, cin, cout):
    args = gblock_inputs(np.random.default_rng(6), 288, hw, hw, cin, cout, dev)
    got = gblock_fused(*args)
    want = gblock_fused_reference(*args)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4


def test_kernels_are_deterministic(dev):
    """Split-K sums in a fixed order with no float atomics: the same inputs give the same bits."""
    gru = gru_inputs(np.random.default_rng(3), 1, 1, 8, 384, dev)
    assert torch.equal(convgru_rollout(*gru, n_steps=3), convgru_rollout(*gru, n_steps=3))
    gb = gblock_inputs(np.random.default_rng(4), 4, 8, 8, 128, 96, dev)
    assert torch.equal(gblock_fused(*gb), gblock_fused(*gb))


def test_kernel_wrappers_refuse_bad_input(dev):
    args = gru_inputs(np.random.default_rng(2), 2, 1, 4, 4, dev)
    with pytest.raises(TypeError, match="float32"):
        convgru_rollout(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        convgru_rollout(args[0], args[1].transpose(1, 2), *args[2:])
    with pytest.raises(ValueError, match="shape"):
        convgru_rollout(args[0], args[1], args[2][..., :3], *args[3:])
    with pytest.raises(ValueError, match="CUDA device"):
        convgru_rollout(args[0], args[1].cpu(), *args[2:])
    # The bf16 wrappers check the same, and a refused launch raises.
    bf = [a.bfloat16() for a in gru_inputs(np.random.default_rng(2), 2, 1, 8, 8, dev)]
    with pytest.raises(ValueError, match="contiguous"):
        convgru_rollout(bf[0], bf[1].transpose(1, 2), *bf[2:])
    with pytest.raises(ValueError, match="shape"):
        convgru_rollout(bf[0], bf[1], bf[2][..., :3], *bf[3:])
    with pytest.raises(TypeError, match="bfloat16"):
        convgru_rollout(bf[0], args[1].new_zeros(bf[1].shape), *bf[2:])
    gb = gblock_inputs(np.random.default_rng(4), 2, 8, 8, 16, 16, dev)
    gb = [a.bfloat16() for a in gb[:4]] + gb[4:]
    with pytest.raises(ValueError, match="shape"):
        gblock_fused(gb[0], gb[1][..., :8], *gb[2:])
    with pytest.raises(ValueError, match="CUDA device"):
        gblock_fused(gb[0], gb[1].cpu(), *gb[2:])
    with pytest.raises(TypeError, match="float32"):
        gblock_fused(*gb[:4], gb[4].bfloat16(), *gb[5:])
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    x = gb[0]
    with pytest.raises(RuntimeError, match="gblock_conv1_bf16: CUDA call failed"):
        # 6 channels: TMA strides must be 16 bytes, so the entry point refuses (the wrapper pads)
        _build.call("gblock_conv1_bf16", *[ptr(x)] * 2, *[ptr(gb[4])] * 4, ptr(x),
                    2, 8, 8, 6, stream)
    with pytest.raises(RuntimeError, match="gru_rollout_bf16: CUDA call failed"):
        # a pointer off the 16-byte alignment TMA needs
        h = bf[1].flatten()[1:]
        _build.call("gru_rollout_bf16", ptr(bf[0]), ptr(h), *[ptr(bf[2])] * 4,
                    *[ptr(gb[4])] * 3, 1, 8, 8, 8, 2, 2, stream)


# The f32 kernels at the main path's shapes at the request batch (B=2 / N=36): within the
# 1e-4 bar, and the same bits on a second call.
@pytest.mark.parametrize("t_in,hw,c", [(1, 8, 384), (3, 16, 192), (3, 32, 96), (3, 64, 48)])
def test_convgru_rollout_f32_kernel_at_the_request_batch(dev, t_in, hw, c):
    args = gru_inputs(np.random.default_rng(13), t_in, 2, hw, c, dev)
    got = convgru_rollout(*args, n_steps=3)
    want = convgru_rollout_reference(*args, n_steps=3)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4
    assert torch.equal(got, convgru_rollout(*args, n_steps=3))


@pytest.mark.parametrize(
    "hw,cin,cout", [(8, 768, 768), (16, 384, 384), (32, 192, 192), (64, 96, 96), (16, 384, 192)]
)
def test_gblock_fused_f32_kernel_at_the_request_batch(dev, hw, cin, cout):
    args = gblock_inputs(np.random.default_rng(14), 36, hw, hw, cin, cout, dev)
    got = gblock_fused(*args)
    want = gblock_fused_reference(*args)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4
    assert torch.equal(got, gblock_fused(*args))


# Ragged windows of the H-sharded forward at 512^2 on two space ranks (chip_smoke.py phase 19a):
# each rank's window of a level (its stripe and the rows the kernel reaches across), rows past
# the window's H masked; the window's stripe rows equal the same rows of the kernel on the
# whole level, bit for bit, for the top window and the bottom one.
@pytest.mark.parametrize("rows,width,window,c", [(16, 16, 10, 768), (64, 64, 34, 192)])
def test_gblock_fused_f32_kernel_on_ragged_windows(dev, rows, width, window, c):
    whole = gblock_inputs(np.random.default_rng(15), 18, rows, width, c, c, dev)
    full = gblock_fused(*whole)
    stripe = rows // 2
    for lo, keep in ((0, 0), (rows - window, window - stripe)):
        args = [whole[0][:, lo:lo + window].contiguous(), *whole[1:]]
        got = gblock_fused(*args)
        assert (got - gblock_fused_reference(*args)).abs().max().item() <= 1e-4
        assert torch.equal(got[:, keep:keep + stripe], full[:, lo + keep:lo + keep + stripe])


@pytest.mark.parametrize("rows,width,window,c", [(128, 128, 101, 48), (32, 32, 32, 192)])
def test_convgru_rollout_f32_kernel_on_ragged_windows(dev, rows, width, window, c):
    rng = np.random.default_rng(16)
    whole = [a.to(dev) for a in (randn(rng, 3, 1, rows, width, 3 * c), randn(rng, 1, rows, width, c),
                                 randn(rng, 3, 3, c, 2 * c, scale=(9 * c) ** -0.5),
                                 randn(rng, 3, 3, c, c, scale=(9 * c) ** -0.5),
                                 randn(rng, 3 * c, scale=0.1))]
    full = convgru_rollout(*whole, n_steps=3)
    stripe = rows // 2
    for lo, keep in ((0, 0), (rows - window, window - stripe)):
        args = [whole[0][:, :, lo:lo + window].contiguous(),
                whole[1][:, lo:lo + window].contiguous(), *whole[2:]]
        got = convgru_rollout(*args, n_steps=3)
        assert (got - convgru_rollout_reference(*args, n_steps=3)).abs().max().item() <= 1e-4
        assert torch.equal(got[:, :, keep:keep + stripe], full[:, :, lo + keep:lo + keep + stripe])


def test_f32_kernels_pad_odd_channel_counts(dev):
    """10 channels pad to 16 (the rollout) or 12 (the GBlock; a 6-channel output to 8) and
    slice back."""
    gru = gru_inputs(np.random.default_rng(17), 3, 2, 6, 10, dev)
    got = convgru_rollout(*gru, n_steps=3)
    assert got.shape == (3, 2, 6, 6, 10) and got.is_contiguous()
    assert (got - convgru_rollout_reference(*gru, n_steps=3)).abs().max().item() <= 1e-5
    gb = gblock_inputs(np.random.default_rng(18), 2, 5, 7, 10, 6, dev)
    got = gblock_fused(*gb)
    assert got.shape == (2, 5, 7, 6) and got.is_contiguous()
    assert (got - gblock_fused_reference(*gb)).abs().max().item() <= 1e-5


def test_f32_entry_points_refuse_what_tma_cannot_load(dev):
    """The f32 kernels' C entry points refuse channels off 16 bytes and misaligned pointers."""
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    gb = gblock_inputs(np.random.default_rng(19), 2, 8, 8, 16, 16, dev)
    x = gb[0]
    with pytest.raises(RuntimeError, match="gblock_conv1_f32: CUDA call failed"):
        # 6 channels: 24-byte strides (the wrapper pads to 8)
        _build.call("gblock_conv1_f32", *[ptr(x)] * 2, *[ptr(gb[4])] * 4, ptr(x),
                    2, 8, 8, 6, stream)
    with pytest.raises(RuntimeError, match="gblock_conv2_f32: CUDA call failed"):
        _build.call("gblock_conv2_f32", ptr(x.flatten()[1:]), *[ptr(x)] * 3, ptr(gb[8]),
                    ptr(x), 0, 2, 8, 8, 16, 16, stream)
    gru = gru_inputs(np.random.default_rng(19), 2, 1, 8, 16, dev)
    with pytest.raises(RuntimeError, match="gru_rollout_f32: CUDA call failed"):
        h = gru[1].flatten()[1:]  # a pointer off the 16-byte alignment TMA needs
        _build.call("gru_rollout_f32", ptr(gru[0]), ptr(h), *[ptr(gru[2])] * 3, ptr(gru[0]),
                    *[ptr(gru[1])] * 3, 1, 8, 8, 16, 2, 2, stream)
    with pytest.raises(RuntimeError, match="gru_rollout_f32: CUDA call failed"):
        # 8 channels: the kernel's gate epilogue takes whole blocks of 16 (the wrapper pads)
        _build.call("gru_rollout_f32", *[ptr(gru[0])] * 9, 1, 8, 8, 8, 2, 2, stream)


TINY = dict(forecast_steps=2, output_shape=64, latent_channels=256, context_channels=32)


def test_tiny_dgmr_on_card_matches_cpu(dev):
    model = random_fill(DGMR(**TINY, device="cpu").eval(), torch.Generator().manual_seed(0))
    x = torch.rand((2, 4, 1, 64, 64), generator=torch.Generator().manual_seed(1))
    z = torch.randn((1, 8, 2, 2), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = model(x, z=z)
        gru, gb = convgru_rollout.launches, gblock_fused.launches
        got = model.to(dev)(x.to(dev), z=z.to(dev)).cpu()
    assert convgru_rollout.launches - gru == 4  # one launch per ConvGRU level
    assert gblock_fused.launches - gb == 4 * 2  # GBlocks x launches per GBlock
    assert (got - want).abs().max().item() <= 1e-4


def test_default_device_model_runs_a_cpu_batch_on_the_card(dev):
    model = random_fill(DGMR(**TINY).eval(), torch.Generator().manual_seed(0))
    assert {p.device.type for p in model.parameters()} == {"cuda"}
    x = torch.rand((2, 4, 1, 64, 64), generator=torch.Generator().manual_seed(1))  # on the CPU
    gru, gb = convgru_rollout.launches, gblock_fused.launches
    out = make_generate(model, num_samples=2)(x, torch.Generator().manual_seed(2))
    assert out.device.type == "cuda" and out.shape == (2, 2, 2, 1, 64, 64)
    assert convgru_rollout.launches - gru == 2 * 4  # samples x levels
    assert gblock_fused.launches - gb == 2 * 4 * 2
    assert bool(torch.isfinite(out).all())


TRAIN_TINY = dict(TINY, generation_steps=2, num_spatial_layers=2, num_temporal_layers=2)


def tiny_train_state(dev):
    model = random_fill(DGMR(**TRAIN_TINY, device=dev), torch.Generator().manual_seed(0))
    training.desaturate_discriminator(model)
    x = torch.rand((2, 4, 1, 64, 64), generator=torch.Generator().manual_seed(1))
    y = torch.rand((2, 2, 1, 64, 64), generator=torch.Generator().manual_seed(2))
    return training.init_train_state(model), x, y


def test_train_step_on_card_launches_no_kernel(dev):
    """Train mode takes the plain paths (the kernels have no backward); state stays on the card."""
    state, x, y = tiny_train_state(dev)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    gru, gb = convgru_rollout.launches, gblock_fused.launches
    metrics = training.make_train_step(state.model)(state, x, y, torch.Generator().manual_seed(3))
    torch.cuda.synchronize()
    assert (convgru_rollout.launches, gblock_fused.launches) == (gru, gb)
    assert len(metrics) == 6 and state.step == 1
    for name, value in metrics.items():
        assert value.device.type == "cuda" and bool(torch.isfinite(value)), name
    after = state.model.state_dict()
    assert {v.device.type for v in after.values()} == {"cuda"}
    for key in ("sampler.g1.bn1.running_mean", "sampler.convGRU4.cell.read_gate_conv"
                ".parametrizations.weight.0._u",
                "discriminator.temporal_discriminator.fc.parametrizations.weight.original"):
        assert not torch.equal(after[key], before[key]), key


def test_eval_step_launches_both_kernels(dev):
    state, x, y = tiny_train_state(dev)
    gru, gb = convgru_rollout.launches, gblock_fused.launches
    metrics = training.make_eval_step(state.model)(state, x, y, torch.Generator().manual_seed(4))
    torch.cuda.synchronize()
    forwards = 2 + TRAIN_TINY["generation_steps"]
    assert convgru_rollout.launches - gru == 4 * forwards
    assert gblock_fused.launches - gb == 8 * forwards
    assert set(metrics) == {"val/d_loss", "val/g_loss", "val/grid_loss", "val/d_loss_first"}
    for name, value in metrics.items():
        assert value.device.type == "cuda" and bool(torch.isfinite(value)), name
    assert state.model.training  # restored


def test_from_pretrained_onto_the_card_is_bit_identical(dev, tmp_path):
    src = random_fill(DGMR(**TRAIN_TINY, device="cpu"), torch.Generator().manual_seed(5)).eval()
    src.save_pretrained(str(tmp_path))
    towers = dict(num_spatial_layers=2, num_temporal_layers=2)
    got = DGMR.from_pretrained(str(tmp_path), **towers)  # the card by default
    assert not got.training
    want = src.state_dict()
    for key, value in got.state_dict().items():
        assert value.device.type == "cuda", key
        assert torch.equal(value.cpu(), want[key]), key


def test_tiled_nowcast_device_on_card_matches_cpu(dev):
    model = random_fill(DGMR(**TINY, device="cpu").eval(), torch.Generator().manual_seed(0))
    frames = np.random.default_rng(3).random((4, 1, 150, 100), np.float32)
    z = torch.randn((1, 8, 2, 2), generator=torch.Generator().manual_seed(4))
    kwargs = dict(tile=64, overlap=16, batch_tiles=5, z=z)
    want = tiled_nowcast_device(model, frames, **kwargs)
    gru, gb = convgru_rollout.launches, gblock_fused.launches
    got = tiled_nowcast_device(model.to(dev), frames, **kwargs, fetch_stripes=3)
    assert convgru_rollout.launches - gru == 4 * 3  # 12 tiles in batches of 5, 5, 2
    assert gblock_fused.launches - gb == 8 * 3
    assert np.abs(got - want).max() <= 1e-3
    np.testing.assert_array_equal(tiled_nowcast_device(model, frames, **kwargs), got)


def test_device_spans_time_the_stream_that_carries_their_work(dev):
    """On the card every span given a tensor gets stream time, from events on its current stream."""
    from skillful_nowcasting_tpu_torch import profiling

    model = random_fill(DGMR(**TINY, device="cpu").eval(), torch.Generator().manual_seed(0))
    model = model.to(dev)
    x = torch.rand((1, 4, 1, 64, 64), generator=torch.Generator().manual_seed(1)).to(dev)
    a = torch.randn((1024, 1024), device=dev)
    side = torch.cuda.Stream(dev)
    with profiling.record(device=True) as log:
        with torch.no_grad():
            model(x)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), profiling.span("side", device=a):
            assert profiling._stream(a) == side
            for _ in range(8):
                a = a @ a / 32
    torch.cuda.current_stream(dev).wait_stream(side)
    spans = log.spans()
    names = [s["name"] for s in spans]
    # On the card each GBlock and rollout derives its weights, then the kernel's layout of them.
    assert names.count("dgmr.derive.gblock") == names.count("dgmr.derive.rollout") == 4
    assert names.count("dgmr.derive.gblock_layout") == names.count("dgmr.derive.rollout_layout") == 4
    assert all(s["stream_ms"] is not None and s["stream_ms"] >= 0 for s in spans)
    forward = next(s for s in spans if s["name"] == "dgmr.forward")
    sampler = next(s for s in spans if s["name"] == "dgmr.sampler")
    assert 0 < sampler["stream_ms"] <= forward["stream_ms"]
    assert next(s for s in spans if s["name"] == "side")["stream_ms"] > 0
    assert profiling._stream(a) == torch.cuda.current_stream(dev)


def test_evaluate_nowcast_on_card_matches_cpu(dev):
    model = random_fill(DGMR(**TINY, device="cpu").eval(), torch.Generator().manual_seed(0))
    rng = np.random.default_rng(8)
    batches = [(rng.random((2, 4, 1, 64, 64), np.float32),
                rng.random((2, 2, 1, 64, 64), np.float32)) for _ in range(2)]
    kwargs = dict(num_samples=2, thresholds=(0.0, 0.1), pools=(1, 4))
    want = evaluate_nowcast(model, batches, generator=torch.Generator().manual_seed(1), **kwargs)
    model.to(dev)
    got = evaluate_nowcast(model, batches, generator=torch.Generator().manual_seed(1), **kwargs)
    for name, value in want.items():
        assert abs(got[name] - value) <= 1e-3, name


def bf16_rel_err(got, want) -> float:
    """max|got - want| over max|want|; one bf16 ulp of the largest output is 2^-7 of it."""
    return (got.float() - want.float()).abs().max().item() / want.float().abs().max().item()


# Ragged channel counts (the wrappers pad them to multiples of 8 for TMA),
# multiples of 8, the main path's levels at B=2 / N=36 and at the tile batch
# (B=16 / N=288), in bf16; the same bits twice.
@pytest.mark.parametrize(
    "t_in,b,hw,c", [(3, 2, 5, 6), (1, 2, 8, 70), (3, 3, 9, 40), (3, 2, 12, 48), (1, 2, 8, 384),
                    (3, 16, 64, 48), (1, 16, 8, 384), (3, 16, 16, 192)],
)
def test_convgru_rollout_bf16_kernel_matches_plain(dev, t_in, b, hw, c):
    args = [a.bfloat16() for a in gru_inputs(np.random.default_rng(7), t_in, b, hw, c, dev)]
    f32, bf16 = convgru_rollout.launches, convgru_rollout.launches_bf16
    got = convgru_rollout(*args, n_steps=3)
    assert (convgru_rollout.launches, convgru_rollout.launches_bf16 - bf16) == (f32, 1)
    assert got.dtype == torch.bfloat16
    want = convgru_rollout_reference(*args, n_steps=3)
    torch.cuda.synchronize()
    assert bf16_rel_err(got, want) <= 2.0**-7
    assert torch.equal(got, convgru_rollout(*args, n_steps=3))


@pytest.mark.parametrize(
    "n,h,w,cin,cout",
    [(2, 7, 5, 6, 6), (3, 8, 9, 20, 12), (2, 6, 6, 70, 70), (4, 8, 8, 128, 128), (4, 9, 7, 96, 64),
     (36, 64, 64, 96, 96), (36, 16, 16, 384, 192), (36, 8, 8, 768, 768), (288, 32, 32, 192, 192)],
)
def test_gblock_fused_bf16_kernel_matches_plain(dev, n, h, w, cin, cout):
    args = gblock_inputs(np.random.default_rng(8), n, h, w, cin, cout, dev)
    args = [a.bfloat16() for a in args[:4]] + args[4:]  # the affines stay f32
    f32, bf16 = gblock_fused.launches, gblock_fused.launches_bf16
    got = gblock_fused(*args)
    assert (gblock_fused.launches, gblock_fused.launches_bf16 - bf16) == (f32, 2)
    assert got.dtype == torch.bfloat16
    want = gblock_fused_reference(*args)
    torch.cuda.synchronize()
    assert bf16_rel_err(got, want) <= 2.0**-7
    assert torch.equal(got, gblock_fused(*args))


def test_bf16_request_runs_only_bf16_kernels(dev):
    model = random_fill(DGMR(**TINY).eval(), torch.Generator().manual_seed(0))
    x = torch.rand((2, 4, 1, 64, 64), generator=torch.Generator().manual_seed(1))
    counts = lambda: (convgru_rollout.launches, gblock_fused.launches,  # noqa: E731
                      convgru_rollout.launches_bf16, gblock_fused.launches_bf16)
    before = counts()
    out = make_generate(model, num_samples=2)(x.bfloat16(), torch.Generator().manual_seed(2))
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out).all())
    assert tuple(a - b for a, b in zip(counts(), before)) == (0, 0, 2 * 4, 2 * 4 * 2)
    ref = make_generate(model, num_samples=2)(x, torch.Generator().manual_seed(2))
    assert (out.float() - ref).abs().max().item() / max(ref.abs().max().item(), 1e-3) < 0.15


def test_artifact_exported_and_served_on_the_card(dev, tmp_path):
    model = random_fill(DGMR(**TINY, num_samples=2).eval(), torch.Generator().manual_seed(0))
    path = str(tmp_path / "tiny.dgmrx")
    meta = serving.save_exported(path, model, batch_size=3, microbatch=2)
    assert meta["device_type"] == "cuda"
    server = serving.load_exported(path).place()  # the card by default
    assert {w.device.type for w in server.weights} == {"cuda"}
    x = torch.rand((3, 4, 1, 64, 64), generator=torch.Generator().manual_seed(1))
    gru = convgru_rollout.launches
    out = server.generate(x, seed=5)
    assert convgru_rollout.launches - gru == 2 * 2 * 4  # samples x chunks x levels
    want = make_generate(model, microbatch=2)(x, torch.Generator().manual_seed(5))
    assert (out - want).abs().max().item() <= 1e-6
    with pytest.raises(ValueError, match="'cuda'.*'cpu'"):
        serving.load_exported(path).place("cpu").generate(x, seed=5)


def test_served_and_tiled_paths_take_card_inputs(dev, tmp_path, monkeypatch):
    """A CUDA ``x`` or ``frames`` gives the bits of the same values from the host.

    The device tiler keeps a field that is already on the card there: no
    tensor goes through numpy on its way in, and ``frames`` stays on the card.
    """
    model = random_fill(DGMR(**TINY, num_samples=2).eval(), torch.Generator().manual_seed(0))
    path = str(tmp_path / "tiny.dgmrx")
    serving.save_exported(path, model, batch_size=2)
    server = serving.load_exported(path).place()
    x = torch.rand((2, 4, 1, 64, 64), generator=torch.Generator().manual_seed(1))
    want = server.generate(x, seed=3)
    assert torch.equal(server.generate(x.to(dev), seed=3), want)
    assert torch.equal(server.generate(x.to(dev).double(), seed=3), want)

    frames = torch.rand((4, 1, 150, 100), generator=torch.Generator().manual_seed(2))
    z = torch.randn((1, 8, 2, 2), generator=torch.Generator().manual_seed(4))
    kwargs = dict(tile=64, overlap=16, batch_tiles=5, z=z)
    on_card = frames.to(dev)
    np.testing.assert_array_equal(tiled_nowcast(model, on_card, **kwargs),
                                  tiled_nowcast(model, frames.numpy(), **kwargs))
    want = tiled_nowcast_device(model, frames.numpy(), **kwargs)

    def no_numpy(*args, **kwargs):
        raise AssertionError("a tensor went through numpy")

    monkeypatch.setattr(torch.Tensor, "__array__", no_numpy)
    got = tiled_nowcast_device(model, on_card, **kwargs)
    monkeypatch.undo()
    np.testing.assert_array_equal(got, want)
    assert on_card.device == dev


def test_prefetch_to_device_delivers_the_host_bits(dev):
    from skillful_nowcasting_tpu_torch.data import prefetch_to_device

    rng = np.random.default_rng(7)
    items = [(rng.random((2, 4, 1, 32, 32), np.float32), np.arange(3)) for _ in range(5)]
    out = list(prefetch_to_device(iter(items), size=2))
    assert len(out) == 5
    for (a, b), (x, y) in zip(out, items):
        assert a.device == dev and a.dtype == torch.float32
        assert np.array_equal(a.cpu().numpy(), x) and np.array_equal(b.cpu().numpy(), y)
    cast = next(prefetch_to_device(iter(items), transfer_dtype=torch.bfloat16))[0]
    assert cast.dtype == torch.bfloat16
    assert torch.equal(cast.cpu(), torch.from_numpy(items[0][0]).bfloat16())


def test_synthetic_radar_batches_device_on_the_card(dev):
    from skillful_nowcasting_tpu_torch.data import synthetic_radar_batches_device

    kw = dict(batch_size=2, input_frames=4, target_frames=18, size=64, seed=3)
    images, future = next(synthetic_radar_batches_device(**kw))
    assert images.device == dev and images.shape == (2, 4, 1, 64, 64)
    assert future.shape == (2, 18, 1, 64, 64) and float(future.max()) > 1.0
    assert torch.equal(images, next(synthetic_radar_batches_device(**kw))[0])


def test_r1_step_on_card_matches_cpu(dev):
    """A tiny float64 R1 step (SGD, fixed draws): card vs CPU to 1e-3 of each tensor."""
    base = random_fill(DGMR(**TRAIN_TINY, device="cpu"), torch.Generator().manual_seed(0))
    training.desaturate_discriminator(base)
    x = torch.rand((2, 4, 1, 64, 64), generator=torch.Generator().manual_seed(1))
    y = torch.rand((2, 2, 1, 64, 64), generator=torch.Generator().manual_seed(2))
    draws = training.draw_step(base, 6, torch.Generator().manual_seed(3))

    def step(device):
        model = DGMR(**TRAIN_TINY, device=device)
        model.load_state_dict(base.state_dict())
        model.double()
        g, d = training.split_params(model)
        state = training.init_train_state(
            model, (torch.optim.SGD(g.values(), lr=5e-5), torch.optim.SGD(d.values(), lr=2e-4)))
        m = training.make_train_step(model, return_grads=True, r1_gamma=10.0)(
            state, x.double(), y.double(), draws=draws)
        cpu = {k: v.detach().cpu() for k, v in m.items() if k.startswith("train/")}
        cpu.update({f"d {k}": v.cpu() for k, v in m["d_grads"].items()})
        cpu.update({f"param {k}": p.detach().cpu() for k, p in model.named_parameters()})
        return cpu

    card, host = step(dev), step("cpu")
    assert host["train/d_r1"].item() > 0
    top = max(v.abs().max().item() for v in host.values())
    for k, want in host.items():
        err = (card[k] - want).abs().max().item()
        assert err <= 1e-3 * max(want.abs().max().item(), 1e-6 * top), (k, err)


def test_mesh_of_one_on_the_card_is_the_plain_step(dev):
    """make_mesh() defaults to this rank's card; a mesh of one trains with the plain step."""
    from skillful_nowcasting_tpu_torch.parallel import make_dp_train_step, make_mesh

    mesh = make_mesh()
    assert mesh.size == 1 and mesh.device.type == "cuda" and mesh.group is None
    state, x, y = tiny_train_state(dev)
    step = make_dp_train_step(state.model, mesh, mode="pjit")
    assert step.__qualname__ == "make_train_step.<locals>.train_step"
    metrics = step(state, x, y, torch.Generator().manual_seed(3))
    assert state.step == 1 and all(bool(torch.isfinite(v)) for v in metrics.values())


def test_nccl_world_of_one(dev, monkeypatch):
    """init_distributed over NCCL from a launcher's environment: one all-reduce; a CPU model refused."""
    import socket

    import torch.distributed as dist

    from skillful_nowcasting_tpu_torch.parallel import init_distributed

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in dict(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    assert init_distributed() == 1
    try:
        assert dist.get_backend() == "nccl"
        buf = torch.arange(1 << 20, dtype=torch.float32, device=dev)
        want = buf.clone()
        dist.all_reduce(buf)
        torch.cuda.synchronize()
        assert torch.equal(buf, want)
        with pytest.raises(ValueError, match="NCCL"):
            training.make_train_step(DGMR(**TINY, device="cpu"), group=dist.group.WORLD)
    finally:
        dist.destroy_process_group()


def test_losses_on_card_match_cpu(dev):
    """Every ported loss of the same tensors, card vs CPU: <= 1e-5 relative; MS-SSIM's gradient."""
    from skillful_nowcasting_tpu_torch import losses

    gen = torch.Generator().manual_seed(90)
    x = torch.rand((2, 3, 1, 176, 180), generator=gen)
    y = (x + 0.1 * torch.randn(x.shape, generator=gen)).clamp(0, 1)
    ens = x + 0.05 * torch.randn((3, *x.shape), generator=gen)
    p = 0.01 + 0.98 * torch.rand((2, 3, 176, 180), generator=gen)
    probs, rain = torch.stack([1 - p, p], 1), (y[:, :, 0] > 0.5).long()
    log_probs, labels = probs.movedim(1, -1).reshape(-1, 2).log(), rain.reshape(-1)
    args = {"focal": (probs, rain), "ssim_dynamic": (x[:, -1:], x, y), "tv": (x[:, 0],),
            "total_variation": (x[:, 0],)}
    for name in ("bce", "binary_crossentropy", "crossentropy"):
        args[name] = (log_probs, labels)
    cases = [(f"get_loss({n})", losses.get_loss(n), args.get(n, (x, y))) for n in losses.LOSS_NAMES]
    cases += [("grid_cell_regularizer", losses.grid_cell_regularizer, (ens, y)),
              ("FocalLoss(alpha=0.25)", losses.FocalLoss(alpha=0.25), (probs, rain)),
              ("ms_ssim(size_average=False)",
               lambda a, b: losses.ms_ssim(a, b, size_average=False).sum(), (x, y))]
    for name, fn, a in cases:
        want = fn(*a).item()
        got = fn(*(v.to(dev) for v in a)).item()
        assert abs(got - want) <= 1e-5 * abs(want), (name, got, want)
    for crit in (losses.MS_SSIMLoss(), losses.SSIMLoss()):
        grads = []
        for d in ("cpu", dev):
            xd = x.detach().to(d).requires_grad_()  # a fresh leaf on each device
            crit(xd, y.to(d)).backward()
            grads.append(xd.grad.cpu())
        assert (grads[1] - grads[0]).abs().max() <= 1e-4 * grads[0].abs().max()


@pytest.mark.parametrize("with_r", [False, True])
def test_coord_conv_on_card_matches_cpu(dev, with_r):
    """CoordConv card vs CPU in f32 and bf16; a train forward advances SN u / v once on the card."""
    import copy

    from skillful_nowcasting_tpu_torch.layers import CoordConv
    from skillful_nowcasting_tpu_torch.ops import spectral_norm as sn

    torch.manual_seed(91)
    cpu = CoordConv(6, 8, with_r, kernel_size=3, padding=1, spectral_norm=True).eval()
    card = copy.deepcopy(cpu).to(dev)
    x = randn(np.random.default_rng(92), 2, 6, 33, 40)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0**-7)):
        want = cpu(x.to(dtype)).float()
        got = card(x.to(dev, dtype)).float().cpu()
        assert (got - want).abs().max() <= tol * want.abs().max()
    card.train()
    par = card.conv.parametrizations.weight
    u0, v0 = par[0]._u.clone(), par[0]._v.clone()
    with torch.no_grad():
        card(x.to(dev))
        u1, v1 = sn.power_iteration(sn.kernel_to_weight_mat(par.original), u0, v0, par[0].eps)
    assert torch.allclose(par[0]._u, u1, atol=1e-6) and torch.allclose(par[0]._v, v1, atol=1e-6)
    assert not torch.equal(par[0]._u, u0)
