"""Blocks and stacks of the PyTorch port vs their JAX modules, eval, on the CPU.

Weights are filled and perturbed on the JAX side and carried across with
``state_dict_from_variables`` + ``load_state_dict(strict=True)``. Tolerance:
rtol 2e-4 / atol 2e-5, the JAX parity suite's per-block bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skillful_nowcasting_tpu import layers as jlayers
from skillful_nowcasting_tpu import models as jmodels
from skillful_nowcasting_tpu_torch import layers, models
from torch_port_helpers import (
    ATOL,
    RTOL,
    jax_variables,
    load_port,
    nchw_to_nhwc,
    nhwc_to_nchw,
    randn,
)

torch.set_num_threads(1)


def check(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(nchw_to_nhwc(got), np.array(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("static", [False, True])
def test_convgru_matches_jax(use_pallas, static):
    steps, b, hw, cin, cout = 3, 2, 8, 6, 4
    rng = np.random.default_rng(0)
    x = randn(rng, b, hw, hw, cin) if static else randn(rng, steps, b, hw, hw, cin)
    h0 = randn(rng, b, hw, hw, cout)
    kw = dict(n_steps=steps, x_static=True) if static else {}
    jgru = jlayers.ConvGRU(cin + cout, cout, use_pallas=use_pallas)
    variables = jax_variables(jgru, jnp.asarray(x), jnp.asarray(h0), seed=1, **kw)
    want = jgru.apply(variables, jnp.asarray(x), jnp.asarray(h0), **kw)  # (T, B, H, W, C)

    gru = load_port(layers.ConvGRU(cin + cout, cout), variables)
    with torch.no_grad():
        got = gru(nhwc_to_nchw(x), nhwc_to_nchw(h0), **kw)  # (T, B, C, H, W)
    assert got.shape == (steps, b, cout, hw, hw)
    check(got, want)


def test_convgru_cell_matches_jax():
    rng = np.random.default_rng(1)
    x, h = randn(rng, 2, 6, 6, 5), randn(rng, 2, 6, 6, 3)
    jcell = jlayers.ConvGRUCell(8, 3)
    variables = jax_variables(jcell, jnp.asarray(x), jnp.asarray(h), seed=2)
    want, _ = jcell.apply(variables, jnp.asarray(x), jnp.asarray(h))
    cell = load_port(layers.ConvGRUCell(8, 3), variables)
    with torch.no_grad():
        got, _ = cell(nhwc_to_nchw(x), nhwc_to_nchw(h))
    check(got, want)


# (name, port constructor, jax constructor, input NHWC shape)
BLOCKS = [
    ("gblock_identity", lambda: models.GBlock(8, 8), lambda: jmodels.GBlock(8, 8), (3, 8, 6, 8)),
    ("gblock_1x1", lambda: models.GBlock(8, 12), lambda: jmodels.GBlock(8, 12), (3, 8, 6, 8)),
    ("upsample_gblock", lambda: models.UpsampleGBlock(8, 4),
     lambda: jmodels.UpsampleGBlock(8, 4), (2, 6, 6, 8)),
    ("dblock_1x1", lambda: models.DBlock(4, 8), lambda: jmodels.DBlock(4, 8), (2, 8, 8, 4)),
    # An identity shortcut needs keep_same_output (the reference never pools x1).
    ("dblock_identity", lambda: models.DBlock(8, 8, keep_same_output=True),
     lambda: jmodels.DBlock(8, 8, keep_same_output=True), (2, 8, 8, 8)),
    ("dblock_same_output", lambda: models.DBlock(4, 8, first_relu=False, keep_same_output=True),
     lambda: jmodels.DBlock(4, 8, first_relu=False, keep_same_output=True), (2, 8, 8, 4)),
    ("lblock_grow", lambda: models.LBlock(8, 16), lambda: jmodels.LBlock(8, 16), (2, 4, 4, 8)),
    ("lblock_same", lambda: models.LBlock(16, 16), lambda: jmodels.LBlock(16, 16), (2, 4, 4, 16)),
]


@pytest.mark.parametrize("name,make,make_jax,shape", BLOCKS, ids=[b[0] for b in BLOCKS])
def test_block_matches_jax(name, make, make_jax, shape):
    x = randn(np.random.default_rng(2), *shape)
    jblock = make_jax()
    variables = jax_variables(jblock, jnp.asarray(x), seed=3)
    want = jblock.apply(variables, jnp.asarray(x), train=False)
    block = load_port(make(), variables)
    with torch.no_grad():
        got = block(nhwc_to_nchw(x))
    check(got, want)


def test_context_conditioning_stack_matches_jax():
    x = randn(np.random.default_rng(3), 2, 4, 64, 64, 1)
    jstack = jmodels.ContextConditioningStack(output_channels=32)
    variables = jax_variables(jstack, jnp.asarray(x), seed=4)
    want = jstack.apply(variables, jnp.asarray(x))
    stack = load_port(models.ContextConditioningStack(output_channels=32), variables)
    with torch.no_grad():
        got = stack(nhwc_to_nchw(x))  # (B, T, C, H, W) in
    assert len(got) == 4
    for g, w in zip(got, want):
        check(g, w)


@pytest.mark.parametrize("num_z", [1, 3])
def test_latent_conditioning_stack_matches_jax(num_z):
    z = randn(np.random.default_rng(4), num_z, 2, 2, 8)
    jstack = jmodels.LatentConditioningStack(shape=(8, 2, 2), output_channels=256)
    variables = jax_variables(jstack, z=jnp.asarray(z), seed=5)
    want = jstack.apply(variables, z=jnp.asarray(z))
    stack = load_port(models.LatentConditioningStack((8, 2, 2), output_channels=256), variables)
    with torch.no_grad():
        got = stack(z=nhwc_to_nchw(z))
    check(got, want)


def test_sampler_matches_jax():
    rng = np.random.default_rng(5)
    b, lc, cc = 2, 64, 16
    states = tuple(randn(rng, b, 16 // 2**i, 16 // 2**i, cc // 8 * 2**i) for i in range(4))
    latent = randn(rng, 1, 2, 2, lc)
    jsampler = jmodels.Sampler(forecast_steps=2, latent_channels=lc, context_channels=cc)
    jstates = tuple(map(jnp.asarray, states))
    variables = jax_variables(jsampler, jstates, jnp.asarray(latent), seed=6)
    want = jsampler.apply(variables, jstates, jnp.asarray(latent))  # (B, T, H, W, C)
    sampler = models.Sampler(forecast_steps=2, latent_channels=lc, context_channels=cc)
    sampler = load_port(sampler, variables)
    with torch.no_grad():
        got = sampler(tuple(map(nhwc_to_nchw, states)), nhwc_to_nchw(latent))
    assert got.shape == (b, 2, 1, 64, 64)
    check(got, want)
