"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here is marked ``cuda`` and skips where CUDA is absent. The file
imports neither JAX nor the JAX package, so it also runs on a GPU machine
without them (``tests/conftest.py`` imports JAX, hence ``--noconftest``):

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from skillful_nowcasting_tpu_torch import DGMR, training
from skillful_nowcasting_tpu_torch.inference import (
    evaluate_nowcast,
    make_generate,
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


# Ragged channel counts (masked scalar loads), a multiple of 4 (16-byte
# cp.async), and the Sampler's 8x8 / C=384 level at B=1: the fewest pixels,
# so the most split-K. Tolerance 1e-5, and 1e-4 (the main path's) at full width.
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
