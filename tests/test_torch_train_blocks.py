"""Train-mode layers, blocks, discriminators and generator: the port vs JAX, on the CPU.

Each case runs one train-mode forward on both sides from the same filled,
perturbed weights and holds the output and the updated ``batch_stats`` /
``spectral`` state (JAX ``apply(..., mutable=[...])`` against the port's
buffers) at rtol 2e-4 / atol 2e-5. The spectral vectors are pulled off their
fixed point first, so that one power iteration moves them and every slice of
a sequential call sees its own sigma.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skillful_nowcasting_tpu import DGMR as JaxDGMR
from skillful_nowcasting_tpu import layers as jlayers
from skillful_nowcasting_tpu import models as jmodels
from skillful_nowcasting_tpu import ops as jops
from skillful_nowcasting_tpu.hub.pretrained import abstract_variables
from skillful_nowcasting_tpu.utils import random_fill_variables
from skillful_nowcasting_tpu_torch import DGMR, layers, models, ops
from skillful_nowcasting_tpu_torch.hub import state_dict_from_variables
from torch_port_helpers import ATOL, RTOL, f64, jax_variables, load_port, perturb, randn, t

torch.set_num_threads(1)

TINY = dict(forecast_steps=2, output_shape=64, latent_channels=256, context_channels=32)


def unsettle(variables, seed: int):
    """Move every spectral ``(u, v)`` off its power-iteration fixed point (still unit vectors)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, tuple):
            moved = [a + 0.5 * rng.standard_normal(a.shape).astype(a.dtype) for a in node]
            return tuple(a / np.linalg.norm(a) for a in moved)
        return node

    return dict(variables, spectral=walk(variables["spectral"]))


def jax_train(module, variables, *args, **kwargs):
    """One jitted train-mode JAX forward: its output and the variables with the updated state."""
    out, mutated = jax.jit(
        lambda v, *a: module.apply(v, *a, mutable=["batch_stats", "spectral"], **kwargs)
    )(variables, *args)
    return np.array(out), {**variables, **jax.tree.map(np.array, dict(mutated))}


def to_port(a, ndim: int = 2) -> torch.Tensor:
    """Channels-last -> channels-first for ``ndim`` spatial dims."""
    return t(np.moveaxis(np.array(a), -1, -(ndim + 1)))


def from_port(x: torch.Tensor, ndim: int = 2) -> np.ndarray:
    return np.moveaxis(np.array(x.detach()), -(ndim + 1), -1)


def check(got, want, port: torch.nn.Module, new_variables) -> None:
    """Output and every BN/SN buffer (``num_batches_tracked`` aside: JAX has none)."""
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    wanted = state_dict_from_variables(new_variables)
    state = port.state_dict()
    assert set(wanted) == set(state)
    for key, value in wanted.items():
        if key.endswith(("_u", "_v", "running_mean", "running_var")):
            np.testing.assert_allclose(
                np.array(state[key]), np.array(value), rtol=RTOL, atol=ATOL, err_msg=key
            )


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("sequential", [False, True])
def test_train_sn_conv_matches_jax(ndim, sequential):
    lead = (3, 2) if sequential else (2,)
    x = randn(np.random.default_rng(0), *lead, *((6, 5) if ndim == 2 else (4, 6, 5)), 4)
    jconv = jops.Conv(7, kernel_size=3, padding=1, ndim=ndim, spectral_norm=True)
    variables = unsettle(jax_variables(jconv, jnp.asarray(x), seed=1), 2)
    want, new = jax_train(jconv, variables, jnp.asarray(x), update_stats=True,
                          sequential=sequential)
    make = ops.conv2d if ndim == 2 else ops.conv3d
    conv = load_port(make(4, 7, 3, padding=1, spectral_norm=True), variables).train()
    xp = to_port(x, ndim)
    got = conv(xp.flatten(0, 1), steps=3) if sequential else conv(xp)
    check(from_port(got.reshape(xp.shape[:-ndim - 1] + got.shape[1:]), ndim), want, conv, new)


@pytest.mark.parametrize("sequential", [False, True])
def test_train_dense_matches_jax(sequential):
    x = randn(np.random.default_rng(1), *((4, 3) if sequential else (3,)), 6)
    jdense = jops.Dense(5, spectral_norm=True)
    variables = unsettle(jax_variables(jdense, jnp.asarray(x), seed=3), 4)
    want, new = jax_train(jdense, variables, jnp.asarray(x), update_stats=True,
                          sequential=sequential)
    dense = load_port(ops.dense(6, 5, spectral_norm=True), variables).train()
    assert dense.parametrizations.weight.original.shape == (5, 6)  # (out, in)
    got = dense(t(x).flatten(0, 1), steps=4) if sequential else dense(t(x))
    check(np.array(got.detach()).reshape(want.shape), want, dense, new)


# (case, NHWC input shape, sequential, port constructor)
BN_CASES = [
    ("plain_4d", (3, 5, 4, 6), False, lambda: ops.BatchNorm2d(6)),
    ("sequential_4d", (3, 2, 5, 4, 6), True, lambda: ops.BatchNorm2d(6)),
    ("sequential_sbc", (4, 3, 6), True, lambda: ops.BatchNorm1d(6)),
]


@pytest.mark.parametrize("case,shape,sequential,make", BN_CASES, ids=[c[0] for c in BN_CASES])
def test_train_batchnorm_matches_jax(case, shape, sequential, make):
    x = randn(np.random.default_rng(2), *shape, scale=2.0) + 0.5
    jbn = jops.TorchBatchNorm()
    variables = jax_variables(jbn, jnp.asarray(x), seed=5)
    want, new = jax_train(jbn, variables, jnp.asarray(x), train=True, sequential=sequential)
    bn = load_port(make(), variables).train()
    xp = t(x) if len(shape) == 3 else to_port(x)
    got = bn(xp.flatten(0, 1), steps=shape[0]) if sequential else bn(xp)
    got = np.array(got.detach()).reshape(xp.shape)
    check(got if len(shape) == 3 else from_port(torch.from_numpy(got)), want, bn, new)
    assert bn.num_batches_tracked.item() == (shape[0] if sequential else 1)


@pytest.mark.parametrize("static", [False, True])
def test_train_convgru_matches_jax(static):
    steps, b, hw, cin, cout = 3, 2, 8, 6, 4
    rng = np.random.default_rng(3)
    x = randn(rng, b, hw, hw, cin) if static else randn(rng, steps, b, hw, hw, cin)
    h0 = randn(rng, b, hw, hw, cout)
    kw = dict(n_steps=steps, x_static=True) if static else {}
    jgru = jlayers.ConvGRU(cin + cout, cout)
    variables = unsettle(jax_variables(jgru, jnp.asarray(x), jnp.asarray(h0), seed=6, **kw), 7)
    want, new = jax_train(jgru, variables, jnp.asarray(x), jnp.asarray(h0), update_stats=True,
                          **kw)
    gru = load_port(layers.ConvGRU(cin + cout, cout), variables).train()
    got = gru(to_port(x), to_port(h0), **kw)
    check(from_port(got), want, gru, new)


# (name, port constructor, jax constructor, NHWC / NDHWC input shape, sequential slices)
BLOCKS = [
    ("gblock_identity", lambda: models.GBlock(8, 8), lambda: jmodels.GBlock(8, 8),
     (3, 2, 6, 5, 8), 3),
    ("gblock_1x1", lambda: models.GBlock(8, 12), lambda: jmodels.GBlock(8, 12),
     (3, 2, 6, 5, 8), 3),
    ("upsample_gblock", lambda: models.UpsampleGBlock(8, 4),
     lambda: jmodels.UpsampleGBlock(8, 4), (2, 2, 4, 4, 8), 2),
    ("dblock_2d", lambda: models.DBlock(4, 8), lambda: jmodels.DBlock(4, 8), (3, 2, 8, 8, 4), 3),
    ("dblock_identity", lambda: models.DBlock(8, 8, keep_same_output=True),
     lambda: jmodels.DBlock(8, 8, keep_same_output=True), (2, 2, 6, 6, 8), 2),
    ("dblock_3d", lambda: models.DBlock(4, 8, conv_type="3d", first_relu=False),
     lambda: jmodels.DBlock(4, 8, conv_type="3d", first_relu=False), (2, 5, 8, 8, 4), None),
]


@pytest.mark.parametrize("name,make,make_jax,shape,steps", BLOCKS, ids=[b[0] for b in BLOCKS])
def test_train_block_matches_jax(name, make, make_jax, shape, steps):
    x = randn(np.random.default_rng(4), *shape)
    jblock = make_jax()
    variables = unsettle(jax_variables(jblock, jnp.asarray(x), seed=8), 9)
    want, new = jax_train(jblock, variables, jnp.asarray(x), train=True,
                          sequential=steps is not None)
    block = load_port(make(), variables).train()
    if steps is None:  # 3-D: NDHWC <-> NCDHW
        got = from_port(block(to_port(x, 3)), 3)
    else:
        xp = to_port(x)
        got = block(xp.flatten(0, 1), steps)
        got = from_port(got.unflatten(0, xp.shape[:2]))
    check(got, want, block, new)


def test_train_discriminators_match_jax():
    # The heads' BatchNorm sees B = 2 rows per frame; two batch elements of
    # different scale keep its E[x^2] - mean^2 away from cancellation.
    rng = np.random.default_rng(5)
    x = rng.random((2, 6, 64, 64, 1), np.float32) * np.float32([1, 4]).reshape(2, 1, 1, 1, 1)
    frames = np.array([5, 0, 5, 2, 3, 3, 1, 4], np.int32)  # with replacement, as Q5 draws
    jspatial = jmodels.SpatialDiscriminator(input_channels=1, num_layers=2)
    variables = unsettle(jax_variables(jspatial, jnp.asarray(x), frame_indices=frames, seed=10), 11)
    want, new = jax_train(jspatial, variables, jnp.asarray(x), train=True,
                          frame_indices=jnp.asarray(frames))
    spatial = load_port(models.SpatialDiscriminator(1, num_layers=2), variables).train()
    got = spatial(to_port(x), frame_indices=t(frames).long())
    assert got.shape == (2, 1, 1)
    check(np.array(got.detach()), want, spatial, new)

    jtemporal = jmodels.TemporalDiscriminator(input_channels=1, num_layers=2)
    variables = unsettle(jax_variables(jtemporal, jnp.asarray(x), seed=12), 13)
    want, new = jax_train(jtemporal, variables, jnp.asarray(x), train=True)
    temporal = load_port(models.TemporalDiscriminator(1, num_layers=2), variables).train()
    got = temporal(to_port(x))
    check(np.array(got.detach()), want, temporal, new)


def test_train_generator_matches_jax():
    """The whole generator in train mode: every per-timestep BN/SN of the Sampler and stacks.

    Compared in float64 on both sides. At f32 the train-mode BatchNorms in
    series amplify rounding past the per-block bound at the output (JAX's
    own f32 result misses its f64 one by more than 2e-5 there); the port's
    f32 forward is held to the end-to-end bound of 1e-3 against the f64 one.
    """
    rng = np.random.default_rng(6)
    x = rng.random((2, 4, 64, 64, 1), np.float32)
    z = randn(rng, 1, 2, 2, 8)
    jmodel = JaxDGMR(**TINY, num_spatial_layers=2, num_temporal_layers=2)
    filled = jax.tree.map(np.array, random_fill_variables(abstract_variables(jmodel), 14))
    variables = unsettle(perturb(filled, 15), 16)
    with jax.enable_x64(True):
        want, new = jax_train(jmodel, f64(variables), jnp.asarray(x, jnp.float64),
                              z=jnp.asarray(z, jnp.float64), train=True)

    def port(dtype):
        model = DGMR(**TINY, num_spatial_layers=2, num_temporal_layers=2, device="cpu")
        model = load_port(model, variables).to(dtype).train()
        return model, model(to_port(x).to(dtype), z=to_port(z).to(dtype))

    model, got = port(torch.float64)
    check(from_port(got), want, model, new)
    assert np.abs(from_port(port(torch.float32)[1]) - want).max() <= 1e-3
