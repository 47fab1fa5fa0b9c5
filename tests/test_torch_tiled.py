"""The port's tiled giant-field nowcasts and seam metric vs the JAX package's, on the CPU.

A tiny DGMR with the same weights on both sides nowcasts a ragged field
(150x100, tile 64, overlap 16) through both tilers with one fixed latent;
the port agrees with JAX at 1e-4 (its end-to-end tiny-generator bound).
The tiling geometry (``_tile_starts``, ``stitch_seam_indices``), the seam
metric and the synthetic smooth field are the JAX package's numpy code and
must agree exactly.
"""

import itertools

import jax
import numpy as np
import pytest
import torch

from skillful_nowcasting_tpu import DGMR as JaxDGMR
from skillful_nowcasting_tpu import inference as jinference
from skillful_nowcasting_tpu.hub.pretrained import abstract_variables
from skillful_nowcasting_tpu.utils import random_fill_variables
from skillful_nowcasting_tpu_torch import DGMR, inference
from skillful_nowcasting_tpu_torch.hub import load_variables
from torch_port_helpers import perturb, randn, t

torch.set_num_threads(1)

TINY = dict(forecast_steps=2, output_shape=64, latent_channels=256, context_channels=32,
            num_spatial_layers=2, num_temporal_layers=2)
TILING = dict(tile=64, overlap=16, batch_tiles=4)
TOL = 1e-4


def to_nhwc(a):
    return np.moveaxis(np.asarray(a), -3, -1)


def to_nchw(a):
    return np.moveaxis(np.asarray(a), -1, -3)


@pytest.fixture(scope="module")
def models():
    jmodel = JaxDGMR(**TINY)
    variables = perturb(
        jax.tree.map(np.array, random_fill_variables(abstract_variables(jmodel), 0)), 1)
    port = DGMR(**TINY, device="cpu")
    assert load_variables(port, variables) == 0
    return jmodel, variables, port.eval()


@pytest.fixture(scope="module")
def field():
    rng = np.random.default_rng(4)
    return rng.random((4, 1, 150, 100), np.float32), randn(rng, 1, 2, 2, 8)  # z NHWC


def test_tile_geometry_matches_jax():
    for n, tile, overlap in itertools.product((40, 64, 100, 150, 257, 1000), (32, 64, 256),
                                              (0, 16, 64)):
        if overlap >= tile:
            continue
        stride = tile - overlap
        assert inference._tile_starts(n, tile, stride) == jinference._tile_starts(n, tile, stride)
        for device in (True, False):
            assert inference.stitch_seam_indices(n, tile, overlap, device) == \
                jinference.stitch_seam_indices(n, tile, overlap, device)


@pytest.mark.parametrize("tiler", ["tiled_nowcast", "tiled_nowcast_device"])
def test_tiler_matches_jax_on_a_ragged_field(models, field, tiler):
    jmodel, variables, port = models
    frames, z = field
    want = getattr(jinference, tiler)(jmodel, variables, to_nhwc(frames), z=z, **TILING)
    got = getattr(inference, tiler)(port, frames, z=t(to_nchw(z)), **TILING)
    assert got.dtype == np.float32 and got.shape == (2, 1, 150, 100)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), rtol=0, atol=TOL)


def test_device_tiler_stripes_are_bit_identical(models, field):
    """Stripes change when copies start, never the tile batches: 12 tiles as 5, 5 and 2."""
    _, _, port = models
    frames, z = field
    kwargs = dict(TILING, batch_tiles=5, z=t(to_nchw(z)))
    one = inference.tiled_nowcast_device(port, frames, **kwargs)
    for stripes in (2, 3, 8):  # 8 > the 4 tile rows: one stripe each
        np.testing.assert_array_equal(
            inference.tiled_nowcast_device(port, frames, **kwargs, fetch_stripes=stripes), one)


def test_single_tile_equals_direct_forward(models):
    _, _, port = models
    rng = np.random.default_rng(5)
    frames = rng.random((4, 1, 64, 64), np.float32)
    z = torch.randn((1, 8, 2, 2), generator=torch.Generator().manual_seed(6))
    got = inference.tiled_nowcast(port, frames, tile=64, overlap=16, z=z)
    with torch.no_grad():
        direct = port(t(frames)[None], z=z)[0].numpy()
    np.testing.assert_array_equal(got, direct)


def test_interior_tile_equals_direct_forward(models):
    """The device tiler's interior pixels are the forward of the tile that wrote them."""
    _, _, port = models
    frames = np.random.default_rng(7).random((4, 1, 160, 160), np.float32)
    z = torch.randn((1, 8, 2, 2), generator=torch.Generator().manual_seed(8))
    out = inference.tiled_nowcast_device(port, frames, tile=64, overlap=16, z=z)
    # margin 8, stride 48: the tile at padded (48, 48) spans real [40, 104) and writes [48, 96).
    with torch.no_grad():
        direct = port(t(frames[None, :, :, 40:104, 40:104]), z=z)[0].numpy()
    np.testing.assert_allclose(out[:, :, 48:96, 48:96], direct[:, :, 8:56, 8:56], rtol=0, atol=1e-5)


def test_seam_metric_and_smooth_field_match_jax(models):
    _, _, port = models
    field = inference.smooth_test_field(4, 150, 100, 1, seed=3)
    want = jinference.smooth_test_field(4, 150, 100, 1, seed=3)
    np.testing.assert_array_equal(to_nhwc(field), want)
    z = torch.randn((1, 8, 2, 2), generator=torch.Generator().manual_seed(9))
    for tiler, device in (("tiled_nowcast", False), ("tiled_nowcast_device", True)):
        out = getattr(inference, tiler)(port, field, z=z, **TILING)
        got = inference.seam_discontinuity(out, tile=64, overlap=16, device=device)
        want = jinference.seam_discontinuity(to_nhwc(out), tile=64, overlap=16, device=device)
        assert got == pytest.approx(want, rel=1e-12)
        assert got["ratio"] <= 2.0, (tiler, got)  # seams at the field's own texture level


def test_tilers_validate_their_arguments(models):
    _, _, port = models
    frames = np.zeros((4, 1, 64, 64), np.float32)
    for tiler in (inference.tiled_nowcast, inference.tiled_nowcast_device):
        for bad in (dict(tile=100, overlap=32), dict(tile=64, overlap=31),
                    dict(tile=64, overlap=64), dict(tile=64, batch_tiles=0)):
            with pytest.raises(ValueError):
                tiler(port, frames, **bad)
        with pytest.raises(NotImplementedError, match="bf16"):
            tiler(port, frames, tile=64, overlap=16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="fetch_stripes"):
        inference.tiled_nowcast_device(port, frames, tile=64, overlap=16, fetch_stripes=0)
    port.train()
    try:
        with pytest.raises(ValueError, match="eval"):
            inference.tiled_nowcast(port, frames, tile=64, overlap=16)
    finally:
        port.eval()
