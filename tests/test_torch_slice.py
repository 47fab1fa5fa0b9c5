"""The port's eval nowcast slice vs the JAX DGMR, and the weight carry-across, on the CPU.

A tiny DGMR's whole variable tree (filled, perturbed; generator and
discriminator) goes through ``state_dict_from_variables`` into the port with
``strict=True``; the whole generator with a fixed latent is held against
``DGMR.apply`` at max-abs 1e-4 (the end-to-end north star is 1e-3).
"""

import jax
import numpy as np
import pytest
import torch

from skillful_nowcasting_tpu import DGMR as JaxDGMR
from skillful_nowcasting_tpu import dgmr as jdgmr
from skillful_nowcasting_tpu.hub.export import export_torch_state_dict
from skillful_nowcasting_tpu.hub.pretrained import abstract_variables
from skillful_nowcasting_tpu.utils import random_fill_variables
from skillful_nowcasting_tpu_torch import DGMR, Generator, dgmr
from skillful_nowcasting_tpu_torch.hub import load_variables, state_dict_from_variables
from skillful_nowcasting_tpu_torch.inference import make_generate
from torch_port_helpers import nchw_to_nhwc, nhwc_to_nchw, perturb, randn, t

torch.set_num_threads(1)

TINY = dict(forecast_steps=2, output_shape=64, latent_channels=256, context_channels=32)
TOWERS = dict(num_spatial_layers=2, num_temporal_layers=2)  # 64^2 admits two halvings a tower
SLICE_TOL = 1e-4


@pytest.fixture(scope="module")
def jax_model_and_variables():
    model = JaxDGMR(**TINY, **TOWERS)
    filled = jax.tree.map(np.array, random_fill_variables(abstract_variables(model), 0))
    return model, perturb(filled, 1)


@pytest.fixture(scope="module")
def port_model(jax_model_and_variables):
    model = DGMR(**TINY, **TOWERS, device="cpu")
    assert load_variables(model, jax_model_and_variables[1]) == 0  # discriminator included
    return model.eval()


def test_state_dict_from_variables_equals_export(jax_model_and_variables):
    variables = jax_model_and_variables[1]
    ours = state_dict_from_variables(variables)
    theirs = export_torch_state_dict(variables)
    assert list(ours) == list(theirs)
    for key, value in theirs.items():
        assert ours[key].dtype == torch.from_numpy(np.asarray(value)).dtype, key
        np.testing.assert_array_equal(np.array(ours[key]), np.asarray(value), err_msg=key)


def test_load_variables_drops_only_discriminator_keys(jax_model_and_variables):
    """The whole JAX DGMR tree, discriminator included, loads strictly; nothing is dropped."""
    variables = jax_model_and_variables[1]
    model = DGMR(**TINY, **TOWERS, device="cpu")
    assert load_variables(model, variables) == 0
    want = export_torch_state_dict(variables)
    assert any(k.startswith("discriminator.") for k in want)
    got = model.state_dict()
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(np.array(got[key]), np.asarray(value), err_msg=key)

    stray = {"bias": np.zeros(2, np.float32)}
    extra = dict(variables, params=dict(variables["params"], stray=stray))
    with pytest.raises(RuntimeError, match="stray"):
        load_variables(DGMR(**TINY, **TOWERS, device="cpu"), extra)


def test_generator_matches_jax_with_fixed_z(jax_model_and_variables, port_model):
    model, variables = jax_model_and_variables
    rng = np.random.default_rng(2)
    x = rng.random((2, 4, 64, 64, 1), np.float32)
    z = randn(rng, 1, 2, 2, 8)
    want = jax.jit(lambda v, x, z: model.apply(v, x, z=z))(variables, x, z)
    m = port_model
    generator = Generator(m.conditioning_stack, m.latent_stack, m.sampler)
    with torch.no_grad():
        got = port_model(nhwc_to_nchw(x), z=nhwc_to_nchw(z))
        composed = generator(nhwc_to_nchw(x), z=nhwc_to_nchw(z))
    assert got.shape == (2, 2, 1, 64, 64)
    err = np.abs(nchw_to_nhwc(got) - np.array(want)).max()
    assert err <= SLICE_TOL, err
    torch.testing.assert_close(composed, got, rtol=0, atol=0)


def test_generate_ensemble_matches_jax(jax_model_and_variables, port_model):
    model, variables = jax_model_and_variables
    rng = np.random.default_rng(3)
    x = rng.random((2, 4, 64, 64, 1), np.float32)
    z = randn(rng, 3, 2, 2, 8)
    want = jax.jit(
        lambda v, x, z: model.apply(v, x, 3, z=z, method=JaxDGMR.generate_ensemble)
    )(variables, x, z)
    with torch.no_grad():
        got = port_model.generate_ensemble(nhwc_to_nchw(x), 3, z=nhwc_to_nchw(z))
    assert got.shape == (3, 2, 2, 1, 64, 64)
    err = np.abs(nchw_to_nhwc(got) - np.array(want)).max()
    assert err <= SLICE_TOL, err


def test_make_generate_shapes_seeds_and_shared_context(port_model):
    x = t(np.random.default_rng(4).random((3, 4, 1, 64, 64), np.float32))
    seed = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    per_sample = make_generate(port_model, num_samples=2)(x, seed(5))
    assert per_sample.shape == (2, 3, 2, 1, 64, 64)
    assert bool(torch.isfinite(per_sample).all())
    assert (per_sample[0] - per_sample[1]).abs().max() > 0  # each sample its own latent
    torch.testing.assert_close(make_generate(port_model, 2)(x, seed(5)), per_sample, rtol=0, atol=0)
    assert (make_generate(port_model, 2)(x, seed(6)) - per_sample).abs().max() > 0
    shared = make_generate(port_model, 2, shared_context=True)(x, seed(5))
    torch.testing.assert_close(shared, per_sample, rtol=1e-5, atol=1e-6)
    chunked = make_generate(port_model, 2, shared_context=True, microbatch=2)(x, seed(5))
    torch.testing.assert_close(chunked, per_sample, rtol=1e-5, atol=1e-6)


def test_config_and_train_mode(port_model):
    assert dgmr.HPARAM_FIELDS == jdgmr.HPARAM_FIELDS
    model = DGMR(**TINY, device="cpu")
    assert model.config == {k: getattr(JaxDGMR(**TINY), k) for k in jdgmr.HPARAM_FIELDS}
    assert "device" not in model.config and "num_spatial_layers" not in model.config
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    assert {b.device.type for b in model.buffers()} == {"cpu"}
    # Train mode runs: batch statistics, and every BN / SN buffer advances.
    model = DGMR(**TINY, **TOWERS, device="cpu")
    model.load_state_dict(port_model.state_dict())
    before = {k: v.clone() for k, v in model.state_dict().items()}
    x = torch.rand((2, 4, 1, 64, 64), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = model.train()(x, generator=torch.Generator().manual_seed(1))
        scores = model.discriminate(torch.cat([x, out], 1), generator=torch.Generator())
    assert out.shape == (2, 2, 1, 64, 64) and scores.shape == (2, 2, 1)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(scores).all())
    after = model.state_dict()
    for key in ("sampler.bn.running_mean", "sampler.convGRU1.cell.output_conv.parametrizations"
                ".weight.0._u", "discriminator.temporal_discriminator.bn.running_var"):
        assert not torch.equal(after[key], before[key]), key
    assert after["sampler.g1.bn1.num_batches_tracked"].item() == TINY["forecast_steps"]


def test_default_device_is_the_card(monkeypatch):
    """Without CUDA the default device raises and names the CPU opt-in; it never runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DGMR(**TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DGMR(**TINY, device=torch.device("cuda", 0))
