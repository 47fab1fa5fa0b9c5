"""The plain reference against the port on the CPU, at a tiny size, on one state dict."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.harness.runner import build_port
from portbench.harness.traffic import Field, compared, gaps
from portbench.harness.weights import make_state_dict
from portbench.reference.dgmr import Numerics, Reference
from portbench.reference.schema import generator_schema
from portbench.reference.tiling import cut_tile, interior, padded_extent, tile_corners
from portbench.tests.tiny import tiny_cell


@pytest.fixture(scope="module")
def tiny():
    cell = tiny_cell("ens.f32.b2")
    sd = make_state_dict(generator_schema(cell.config), 11, "cpu")
    return cell.config, sd, build_port(cell.config, sd, "cpu")


def test_schema_is_the_ports_generator(tiny):
    config, sd, model = tiny
    ports = {k: tuple(v.shape) for k, v in model.state_dict().items()
             if not k.startswith("discriminator.")}
    assert {k: tuple(v.shape) for k, v in sd.items()} == ports


def test_reference_forward_matches_the_port(tiny):
    config, sd, model = tiny
    x = torch.rand((2, 4, 1, 64, 64), generator=torch.Generator().manual_seed(3)) * 10
    z = torch.randn((1, 8, 2, 2), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        got = model(x, z=z)
    want = Reference(sd, config["forecast_steps"]).forward(x, z)
    assert want.shape == got.shape == (2, 3, 1, 64, 64)
    assert want.std() > 1e-3  # the seeded weights give a nowcast that is not constant
    assert compared([gaps(got, want)])["rel_l2"] < 1e-5


def test_reference_ensemble_matches_make_generate(tiny):
    from skillful_nowcasting_tpu_torch.inference import make_generate

    config, sd, model = tiny
    x = torch.rand((2, 4, 1, 64, 64), generator=torch.Generator().manual_seed(5)) * 10
    got = make_generate(model, num_samples=3)(x, torch.Generator().manual_seed(6))
    z = torch.randn((3, 8, 2, 2), generator=torch.Generator().manual_seed(6))
    ref = Reference(sd, config["forecast_steps"])
    want = torch.stack([ref.forward(x, z[s:s + 1]) for s in range(3)])
    assert compared([gaps(got, want)])["rel_l2"] < 1e-5


def test_tiles_cover_the_field_once():
    h, w, tile, overlap = 151, 229, 64, 16
    seen = np.zeros((h, w), int)
    for i, j in tile_corners(h, w, tile, overlap):
        fy, fx, ty, tx = interior(i, j, h, w, tile, overlap)
        assert (fy.stop - fy.start, fx.stop - fx.start) == (ty.stop - ty.start, tx.stop - tx.start)
        seen[fy, fx] += 1
    assert (seen == 1).all()
    assert padded_extent(100, 64, 16) == 64 + 2 * 48  # 116 past one tile: two strides


def test_cut_tile_repeats_edges():
    frames = np.arange(2 * 1 * 5 * 7, dtype=np.float32).reshape(2, 1, 5, 7)
    t = cut_tile(frames, 0, 0, 8, 4)  # 2 rows and columns of repeated edge above and left
    assert t.shape == (2, 1, 8, 8)
    assert (t[:, :, :3, :3] == frames[:, :, :1, :1]).all()
    assert (t[:, :, 2:7, 2:9] == frames[:, :, :5, :6]).all()
    assert (t[:, :, 7] == t[:, :, 6]).all()  # the bottom edge repeated


@pytest.mark.parametrize("dtype, limit", [(torch.float32, 1e-5), (torch.bfloat16, 5e-2)])
def test_reference_stitch_matches_tiled_nowcast_device(dtype, limit):
    """Each tile interior of the port's field, corners and odd edges too, against the reference."""
    from skillful_nowcasting_tpu_torch.inference import tiled_nowcast_device

    cell = tiny_cell("conus.bf16")
    config, mix = cell.config, cell.traffic
    mix.update(height=77, width=141, check_tiles=10 ** 6, check_fields=1)
    sd = make_state_dict(generator_schema(config), 12, "cpu")
    model = build_port(config, sd, "cpu")
    field = Field(config, mix, 13, "cpu", dtype)
    k = sorted(field.checked)[0]
    out = tiled_nowcast_device(model, field.pool[k % mix["pool"]], tile=mix["tile"],
                               overlap=mix["overlap"], batch_tiles=mix["batch_tiles"],
                               z=field.z(k), dtype=dtype)
    rows = field.check({k: out}, Reference(sd, config["forecast_steps"]))
    assert len(rows) == len(field.corners)
    assert max(compared([r])["rel_l2"] for r in rows) < limit


def test_numerics_controls_round_operands():
    x = torch.tensor([1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, -3.0, 1e-3])
    tf32 = Numerics("tf32").operand(x)
    assert tf32.tolist()[:3] == [1.0, 1.0 + 2 * 2.0**-10, -3.0]  # nearest even at 10 bits
    assert abs(tf32[3] - 1e-3) <= 1e-3 * 2.0**-11
    y = torch.linspace(-5, 5, 101)
    fp8 = Numerics("fp8").operand(y)
    assert (fp8 - y).abs().max() <= 5 * 2.0**-4 and not torch.equal(fp8, y)
    assert torch.equal(Numerics("f32").operand(y), y)
