"""The port's bf16 serving config against the JAX package's, on the CPU.

* The plain bf16 versions of both kernels (what the bf16 CUDA kernels
  compute: f32 ``h`` / ``r * h`` / ``mid`` rounded to bf16 as they enter a
  conv, f32 sums, bf16 out) against the Pallas kernels given the same bf16
  operands in interpret mode, within 2^-6 of the output scale: the Pallas
  kernels keep those f32 operands unrounded in interpret mode, and both
  round the output to bf16 (2^-8 of a value).
* The tiny port model in bf16 against JAX's ``model.apply`` in f32 and in
  bf16, and both tilers with ``dtype=torch.bfloat16`` against JAX's with
  ``dtype=jnp.bfloat16`` (f32 stitched output): within 0.15 of the scale,
  the JAX suite's bf16 bar (``tests/test_inference.py:315-316``).
* A float32 / bfloat16 operand mix raises instead of casting.

The JAX references are computed once per test run and shared by every
xdist worker (``run_once``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skillful_nowcasting_tpu import DGMR as JaxDGMR
from skillful_nowcasting_tpu import inference as jinference
from skillful_nowcasting_tpu.hub.pretrained import abstract_variables
from skillful_nowcasting_tpu.ops import pallas_gblock, pallas_gru
from skillful_nowcasting_tpu.utils import random_fill_variables
from skillful_nowcasting_tpu_torch import DGMR, inference
from skillful_nowcasting_tpu_torch.hub import load_variables
from skillful_nowcasting_tpu_torch.ops import (
    convgru_rollout,
    convgru_rollout_reference,
    gblock_fused,
    gblock_fused_reference,
)
from torch_port_helpers import perturb, run_once, t

torch.set_num_threads(1)

TINY = dict(forecast_steps=2, output_shape=64, latent_channels=256, context_channels=32,
            num_spatial_layers=2, num_temporal_layers=2)
TILING = dict(tile=64, overlap=16, batch_tiles=4)
KERNEL_TOL = 2.0**-6  # of max|Pallas|
BF16_TOL = 0.15  # of max(max|reference|, 1e-3)
STEPS = 3
GRU_SHAPES = {"static": (1, 2, 6, 8), "sequence": (STEPS, 2, 6, 8)}  # t_in, B, H=W, C
GBLOCK_SHAPES = {"identity": (2, 8, 8, 8), "shortcut": (2, 8, 16, 8)}  # N, H=W, Cin, Cout


def bf16_exact(a) -> np.ndarray:
    """f32 values exactly representable in bf16 (JAX's rounding), so both sides see the same bits."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def gru_operands(name):
    t_in, b, hw, c = GRU_SHAPES[name]
    rng = np.random.default_rng(t_in)
    s = (9 * c) ** -0.5
    shapes = [(t_in, b, hw, hw, 3 * c), (b, hw, hw, c), (3, 3, c, 2 * c), (3, 3, c, c), (3 * c,)]
    return [bf16_exact(rng.standard_normal(sh) * sc)
            for sh, sc in zip(shapes, (1.0, 1.0, s, s, 0.1))]


def gblock_operands(name):
    n, hw, cin, cout = GBLOCK_SHAPES[name]
    rng = np.random.default_rng(cin + cout)
    low = [bf16_exact(rng.standard_normal(sh) * sc) for sh, sc in (
        ((n, hw, hw, cin), 1.0), ((3, 3, cin, cin), (9 * cin) ** -0.5),
        ((3, 3, cin, cout), (9 * cin) ** -0.5), ((1, 1, cin, cout), cin ** -0.5))]
    affine = [(1.0 + 0.1 * rng.standard_normal(cin)).astype(np.float32),
              (0.1 * rng.standard_normal(cin)).astype(np.float32),
              (1.0 + 0.1 * rng.standard_normal(cin)).astype(np.float32),
              (0.1 * rng.standard_normal(cin)).astype(np.float32),
              (0.1 * rng.standard_normal(cout)).astype(np.float32)]
    return low, affine, cin != cout


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Tiny variables, inputs, and every JAX bf16 / f32 reference output (f32 numpy)."""

    def start():
        bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
        f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))  # noqa: E731
        out = {}
        for name in GRU_SHAPES:
            out[f"gru_{name}"] = f32(pallas_gru.convgru_rollout(
                *map(bf, gru_operands(name)), n_steps=STEPS, interpret=True))
        for name in GBLOCK_SHAPES:
            low, affine, sc = gblock_operands(name)
            out[f"gblock_{name}"] = f32(pallas_gblock.gblock_fused(
                *map(bf, low), *map(jnp.asarray, affine), use_sc_conv=sc, tile_rows=4,
                interpret=True))

        jmodel = JaxDGMR(**TINY)
        variables = perturb(
            jax.tree.map(np.array, random_fill_variables(abstract_variables(jmodel), 0)), 1)
        rng = np.random.default_rng(7)
        x = rng.random((2, 4, 64, 64, 1), np.float32)
        z = rng.standard_normal((1, 2, 2, 8)).astype(np.float32)
        apply = jax.jit(lambda v, x, z: jmodel.apply(v, x, train=False, z=z))
        out["apply_f32"] = f32(apply(variables, x, z))
        out["apply_bf16"] = f32(apply(variables, bf(x), bf(z)))
        field = rng.random((4, 100, 90, 1), np.float32)
        for tiler in ("tiled_nowcast", "tiled_nowcast_device"):
            out[tiler] = f32(getattr(jinference, tiler)(
                jmodel, variables, field, z=z, dtype=jnp.bfloat16, **TILING))
        out.update(variables=variables, x=x, z=z, field=field)
        return lambda: out

    return run_once(tmp_path_factory, "test_torch_bf16_jax", start)[0]


@pytest.fixture(scope="module")
def port(reference):
    model = DGMR(**TINY, device="cpu")
    assert load_variables(model, reference["variables"]) == 0
    return model.eval()


def nchw(a) -> torch.Tensor:
    return t(np.moveaxis(np.asarray(a), -1, -3))


def nhwc(x) -> np.ndarray:
    return np.moveaxis(np.array(x.detach().float()), -3, -1)


def rel_err(got: np.ndarray, want: np.ndarray, floor: float = 0.0) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), floor))


@pytest.mark.parametrize("name", list(GRU_SHAPES))
def test_convgru_rollout_bf16_plain_matches_pallas(reference, name):
    args = [t(a).bfloat16() for a in gru_operands(name)]
    got = convgru_rollout(*args, n_steps=STEPS)  # CPU tensors: the plain version
    assert got.dtype == torch.bfloat16 and got.shape == (STEPS, *args[1].shape)
    assert torch.equal(got, convgru_rollout_reference(*args, n_steps=STEPS))
    assert rel_err(np.array(got.float()), reference[f"gru_{name}"]) <= KERNEL_TOL


@pytest.mark.parametrize("name", list(GBLOCK_SHAPES))
def test_gblock_fused_bf16_plain_matches_pallas(reference, name):
    low, affine, sc = gblock_operands(name)
    args = [t(a).bfloat16() for a in low] + [t(a) for a in affine] + [sc]
    got = gblock_fused(*args)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, gblock_fused_reference(*args))
    assert rel_err(np.array(got.float()), reference[f"gblock_{name}"]) <= KERNEL_TOL


def test_bf16_operand_mix_raises():
    gru = [t(a) for a in gru_operands("sequence")]
    with pytest.raises(TypeError, match="one dtype"):
        convgru_rollout(gru[0].bfloat16(), *gru[1:], n_steps=STEPS)
    low, affine, sc = gblock_operands("shortcut")
    args = [t(a).bfloat16() for a in low] + [t(a) for a in affine] + [sc]
    args[2] = args[2].float()  # k2 in f32 beside a bf16 x
    with pytest.raises(TypeError, match="k2"):
        gblock_fused(*args)
    args = [t(a).bfloat16() for a in low] + [t(a).bfloat16() for a in affine] + [sc]
    with pytest.raises(TypeError, match="a1"):  # the affines stay f32
        gblock_fused(*args)


def test_port_bf16_forward_matches_jax(reference, port):
    """One f32 model serves a bf16 request: bf16 out, near JAX's f32 and bf16 forwards."""
    with torch.no_grad():
        got = port(nchw(reference["x"]).bfloat16(), z=nchw(reference["z"]))
    assert got.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in port.parameters())
    got = nhwc(got)
    assert np.isfinite(got).all()
    for ref in ("apply_f32", "apply_bf16"):
        assert rel_err(got, reference[ref], 1e-3) < BF16_TOL, ref


@pytest.mark.parametrize("tiler", ["tiled_nowcast", "tiled_nowcast_device"])
def test_tiler_bf16_matches_jax(reference, port, tiler):
    field = np.moveaxis(reference["field"], -1, 1)  # (T, C, H, W)
    got = getattr(inference, tiler)(port, field, z=nchw(reference["z"]), dtype=torch.bfloat16,
                                    **TILING)
    assert got.dtype == np.float32 and got.shape == (2, 1, 100, 90)
    assert np.isfinite(got).all()
    assert rel_err(np.moveaxis(got, 1, -1), reference[tiler], 1e-3) < BF16_TOL
