"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here is marked ``cuda`` and skips where CUDA is absent. The file
imports neither JAX nor the JAX package, so it also runs on a GPU machine
without them (``tests/conftest.py`` imports JAX, hence ``--noconftest``):

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from skillful_nowcasting_tpu_torch import DGMR
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


@pytest.mark.parametrize("t_in,b,hw,c", [(3, 2, 5, 6), (1, 2, 8, 70), (3, 3, 9, 40)])
def test_convgru_rollout_kernel_matches_plain(dev, t_in, b, hw, c):
    steps = 3
    args = gru_inputs(np.random.default_rng(0), t_in, b, hw, c, dev)
    before = convgru_rollout.launches
    got = convgru_rollout(*args, n_steps=steps)
    assert convgru_rollout.launches - before == 2 * steps
    want = convgru_rollout_reference(*args, n_steps=steps)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("n,h,w,cin,cout", [(2, 7, 5, 6, 6), (3, 8, 9, 20, 12), (2, 6, 6, 70, 70)])
def test_gblock_fused_kernel_matches_plain(dev, n, h, w, cin, cout):
    rng = np.random.default_rng(1)
    shapes = [(n, h, w, cin), (3, 3, cin, cin), (3, 3, cin, cout), (1, 1, cin, cout)]
    scales = [1.0, (9 * cin) ** -0.5, (9 * cin) ** -0.5, cin**-0.5]
    args = [randn(rng, *shape, scale=sc).to(dev) for shape, sc in zip(shapes, scales)]
    args += [randn(rng, cin).to(dev) for _ in range(4)] + [randn(rng, cout).to(dev), cin != cout]
    before = gblock_fused.launches
    got = gblock_fused(*args)
    assert gblock_fused.launches - before == 2
    want = gblock_fused_reference(*args)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5


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


def test_tiny_dgmr_on_card_matches_cpu(dev):
    model = random_fill(DGMR(forecast_steps=2, output_shape=64, latent_channels=256,
                             context_channels=32).eval(), torch.Generator().manual_seed(0))
    x = torch.rand((2, 4, 1, 64, 64), generator=torch.Generator().manual_seed(1))
    z = torch.randn((1, 8, 2, 2), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = model(x, z=z)
        gru, gb = convgru_rollout.launches, gblock_fused.launches
        got = model.to(dev)(x.to(dev), z=z.to(dev)).cpu()
    assert convgru_rollout.launches - gru == 4 * 2 * 2  # levels x steps x launches per step
    assert gblock_fused.launches - gb == 4 * 2  # GBlocks x launches per GBlock
    assert (got - want).abs().max().item() <= 1e-4
