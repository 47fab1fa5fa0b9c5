"""The port's hub (safetensors, from/save_pretrained, compose_generator, Lightning) vs JAX's.

On the CPU, at a tiny config. Checkpoints cross both ways in the reference
torch schema: the JAX package's ``save_torch_checkpoint`` directories (with
and without the ``generator.*`` duplicates) load in the port, the port's
``save_pretrained`` directories load in JAX, and both sides' forwards agree
with the same latent at the per-block tolerances (rtol 2e-4 / atol 2e-5).
The Lightning test resumes a synthesized reference ``.ckpt`` (one torch Adam
step of each optimizer, in a module order other than the port's) on both
sides and holds parameters, both moment trees and the step counts equal.
"""

import json
import os

import jax
import numpy as np
import optax
import pytest
import torch

from skillful_nowcasting_tpu import DGMR as JaxDGMR
from skillful_nowcasting_tpu import models as jmodels
from skillful_nowcasting_tpu import training as jtraining
from skillful_nowcasting_tpu.hub import build_module as jax_build_module
from skillful_nowcasting_tpu.hub import train_state_from_lightning as jax_train_state_from_lightning
from skillful_nowcasting_tpu.hub.export import save_torch_checkpoint
from skillful_nowcasting_tpu.hub.pretrained import abstract_variables
from skillful_nowcasting_tpu.utils import random_fill_variables
from skillful_nowcasting_tpu_torch import DGMR, Generator, models
from skillful_nowcasting_tpu_torch.hub import (
    compose_generator,
    load_variables,
    module_config,
    state_dict_from_variables,
    train_state_from_lightning,
)
from skillful_nowcasting_tpu_torch.hub import safetensors as st
from skillful_nowcasting_tpu_torch.hub.pretrained import SAFETENSORS_NAME, reference_state_dict
from torch_port_helpers import ATOL, RTOL, nchw_to_nhwc, nhwc_to_nchw, perturb, randn

torch.set_num_threads(1)

TINY = dict(forecast_steps=2, output_shape=64, latent_channels=256, context_channels=32)
TOWERS = dict(num_spatial_layers=2, num_temporal_layers=2)  # kept out of config.json, as in JAX


@pytest.fixture(scope="module")
def jax_side():
    model = JaxDGMR(**TINY, **TOWERS)
    filled = jax.tree.map(np.array, random_fill_variables(abstract_variables(model), 0))
    forward = jax.jit(lambda v, x, z: model.apply(v, x, z=z))
    return model, perturb(filled, 1), forward


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(2)
    return rng.random((2, 4, 64, 64, 1), np.float32), randn(rng, 1, 2, 2, 8)


@pytest.fixture(scope="module")
def port_model(jax_side):
    model = DGMR(**TINY, **TOWERS, device="cpu")
    assert load_variables(model, jax_side[1]) == 0
    return model.eval()


def port_forward(model, inputs):
    x, z = inputs
    with torch.no_grad():
        return nchw_to_nhwc(model(nhwc_to_nchw(x), z=nhwc_to_nchw(z)))


def jax_forward(jax_side, variables, inputs):
    return np.array(jax_side[2](variables, *inputs))


def assert_state_equal(got: torch.nn.Module, want: dict):
    sd = got.state_dict()
    assert set(sd) == set(want)
    for k, v in want.items():
        assert torch.equal(sd[k], torch.as_tensor(v)), k


# --- safetensors --------------------------------------------------------------


SAMPLE = {
    "w": np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32),
    "d": np.random.default_rng(1).standard_normal((2, 2)),
    "h": np.random.default_rng(2).standard_normal(5).astype(np.float16),
    "n": np.arange(6, dtype=np.int64).reshape(2, 3),
    "i": np.array(7, np.int32),
    "e": np.zeros((0, 3), np.float32),
}


@pytest.mark.parametrize("writer", ["port", "package"])
def test_safetensors_interchange(tmp_path, writer):
    """Our writer's files read in the ``safetensors`` package and the package's files in ours."""
    sn = pytest.importorskip("safetensors.numpy")
    stt = pytest.importorskip("safetensors.torch")
    path, bf_path = str(tmp_path / "a.safetensors"), str(tmp_path / "b.safetensors")
    bf = {"bf": torch.randn(3, 5, generator=torch.Generator().manual_seed(3)).bfloat16()}
    if writer == "port":
        st.save_file(SAMPLE, path)
        st.save_file(bf, bf_path)
        back, bf_back = sn.load_file(path), stt.load_file(bf_path)
        for k, v in SAMPLE.items():
            assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
    else:
        sn.save_file(SAMPLE, path)
        stt.save_file(bf, bf_path)
        ours, bf_back = st.load_file(path), st.load_file(bf_path)
        for k, v in SAMPLE.items():
            assert np.array_equal(ours[k].numpy(), v) and ours[k].numpy().dtype == v.dtype, k
    assert bf_back["bf"].dtype == torch.bfloat16 and torch.equal(bf_back["bf"], bf["bf"])


def test_safetensors_refuses_bad_files(tmp_path):
    path = str(tmp_path / "x.safetensors")
    st.save_file({"a": np.zeros(4, np.float32)}, path)
    raw = open(path, "rb").read()
    with open(path, "wb") as f:  # cut the data block short
        f.write(raw[:-4])
    with pytest.raises(ValueError, match="data_offsets"):
        st.load_file(path)
    with open(path, "wb") as f:
        f.write(b"\xff" * 8)
    with pytest.raises(ValueError, match="header length"):
        st.load_file(path)


# --- JAX checkpoints into the port, the port's into JAX -------------------------


@pytest.mark.parametrize("duplicate_generator", [False, True])
def test_jax_checkpoint_loads_in_port_and_jax(tmp_path, jax_side, inputs, duplicate_generator):
    model, variables, _ = jax_side
    save_torch_checkpoint(str(tmp_path), variables, model.config,
                          duplicate_generator=duplicate_generator)
    port = DGMR.from_pretrained(str(tmp_path), device="cpu", **TOWERS)
    assert not port.training and port.forecast_steps == TINY["forecast_steps"]
    assert_state_equal(port, state_dict_from_variables(variables))
    bound = JaxDGMR.from_pretrained(str(tmp_path), **TOWERS)
    np.testing.assert_allclose(port_forward(port, inputs),
                               jax_forward(jax_side, bound.variables, inputs), rtol=RTOL, atol=ATOL)


def test_port_save_loads_in_jax(tmp_path, jax_side, port_model, inputs):
    nbytes = port_model.save_pretrained(str(tmp_path))
    assert nbytes == os.path.getsize(tmp_path / SAFETENSORS_NAME)
    keys = list(st.read_header(str(tmp_path / SAFETENSORS_NAME))[1])
    assert keys == list(reference_state_dict(port_model))  # generator.* before discriminator.*
    assert any(k.startswith("generator.sampler.") for k in keys)
    with open(tmp_path / "config.json") as f:
        assert json.load(f) == port_model.config
    card = port_model.model_card("org/dgmr")
    assert card.startswith("---\nlibrary_name: skillful_nowcasting_tpu_torch\n")
    assert 'DGMR.from_pretrained("org/dgmr")' in card and '"latent_channels": 256' in card
    bound = JaxDGMR.from_pretrained(str(tmp_path), **TOWERS)
    np.testing.assert_allclose(port_forward(port_model, inputs),
                               jax_forward(jax_side, bound.variables, inputs), rtol=RTOL, atol=ATOL)
    again = DGMR.from_pretrained(str(tmp_path), device="cpu", **TOWERS)
    assert_state_equal(again, port_model.state_dict())


def old_style(sd: dict) -> dict:
    """The keys of the old ``torch.nn.utils.spectral_norm``, with the derived ``weight``."""
    out = {}
    for k, v in sd.items():
        if k.endswith(".parametrizations.weight.original"):
            mod = k[: -len(".parametrizations.weight.original")]
            u = sd[f"{mod}.parametrizations.weight.0._u"]
            vv = sd[f"{mod}.parametrizations.weight.0._v"]
            out[f"{mod}.weight_orig"] = v
            out[f"{mod}.weight_u"], out[f"{mod}.weight_v"] = u, vv
            wm = v.reshape(v.shape[0], -1)
            out[f"{mod}.weight"] = v / torch.dot(u, wm @ vv)
        elif not k.endswith(("._u", "._v")):
            out[k] = v
    return out


def test_old_style_keys_and_duplicates_load(tmp_path, port_model, inputs):
    """Old spectral-norm keys, ``generator.*`` copies, no ``num_batches_tracked``, in a .bin."""
    sd = old_style(reference_state_dict(port_model))
    sd = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    sd["conditioning_stack.d1.unused_buffer"] = torch.zeros(3)  # a leaf JAX ignores too
    torch.save(sd, tmp_path / "pytorch_model.bin")
    with open(tmp_path / "config.json", "w") as f:
        json.dump(port_model.config, f)
    got = DGMR.from_pretrained(str(tmp_path), device="cpu", **TOWERS)
    want = {k: (torch.zeros_like(v) if k.endswith("num_batches_tracked") else v)
            for k, v in port_model.state_dict().items()}
    assert_state_equal(got, want)
    np.testing.assert_array_equal(port_forward(got, inputs), port_forward(port_model, inputs))


def test_compose_generator_from_saved_stacks(tmp_path, port_model, inputs):
    parts = {}
    for name, cls in (("conditioning_stack", models.ContextConditioningStack),
                      ("latent_stack", models.LatentConditioningStack),
                      ("sampler", models.Sampler)):
        getattr(port_model, name).save_pretrained(str(tmp_path / name))
        parts[name] = cls.from_pretrained(str(tmp_path / name), device="cpu")
        assert_state_equal(parts[name], getattr(port_model, name).state_dict())
    gen = compose_generator(parts["conditioning_stack"], parts["latent_stack"], parts["sampler"])
    assert isinstance(gen, Generator) and not gen.training
    np.testing.assert_array_equal(port_forward(gen, inputs), port_forward(port_model, inputs))
    gen.save_pretrained(str(tmp_path / "generator"))
    with open(tmp_path / "generator" / "config.json") as f:
        assert set(json.load(f)) == {"conditioning_stack", "latent_stack", "sampler"}
    with pytest.raises(ValueError, match="compose_generator"):
        Generator.from_pretrained(str(tmp_path / "generator"), device="cpu")


@pytest.mark.parametrize(
    "cls,kwargs",
    [
        (models.Discriminator, dict(input_channels=1, **TOWERS)),
        (models.SpatialDiscriminator, dict(input_channels=1, num_layers=2)),
        (models.TemporalDiscriminator, dict(input_channels=1, num_layers=2)),
    ],
)
def test_discriminators_round_trip(tmp_path, port_model, cls, kwargs):
    src = cls(**kwargs)
    disc = port_model.discriminator
    part = {models.Discriminator: disc, models.SpatialDiscriminator: disc.spatial_discriminator,
            models.TemporalDiscriminator: disc.temporal_discriminator}[cls]
    src.load_state_dict(part.state_dict(), strict=True)
    src.save_pretrained(str(tmp_path))
    got = cls.from_pretrained(str(tmp_path), device="cpu")
    assert_state_equal(got, part.state_dict())
    x = torch.rand((2, 6, 1, 64, 64), generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        args = (x,) if cls is models.TemporalDiscriminator else (x, torch.tensor([0, 2, 5, 1]))
        assert torch.equal(got(*args), src.eval()(*args))


def test_port_configs_build_the_jax_modules():
    """Each class's saved config builds the same module in the JAX package's ``build_module``."""
    pairs = [
        (models.ContextConditioningStack(), jmodels.ContextConditioningStack),
        (models.LatentConditioningStack(shape=(8, 2, 2), output_channels=256),
         jmodels.LatentConditioningStack),
        (models.Sampler(forecast_steps=3, latent_channels=256, context_channels=32),
         jmodels.Sampler),
        (models.SpatialDiscriminator(input_channels=1, num_layers=2), jmodels.SpatialDiscriminator),
        (models.TemporalDiscriminator(input_channels=1, num_layers=2),
         jmodels.TemporalDiscriminator),
        (models.Discriminator(input_channels=1, **TOWERS), jmodels.Discriminator),
    ]
    for port, jcls in pairs:
        cfg = json.loads(json.dumps(module_config(port)))
        jax_module = jax_build_module(jcls, cfg)
        for k, v in cfg.items():
            got = getattr(jax_module, k)
            assert (list(got) if isinstance(got, tuple) else got) == v, (jcls.__name__, k)


def test_bad_checkpoints_raise(tmp_path, port_model):
    port_model.save_pretrained(str(tmp_path))
    path = str(tmp_path / SAFETENSORS_NAME)
    sd = st.load_file(path)
    kw = dict(device="cpu", **TOWERS)
    missing = "sampler.g1.bn1.running_mean"
    st.save_file({k: v for k, v in sd.items() if k != missing}, path)
    with pytest.raises(RuntimeError, match=missing.replace(".", r"\.")):
        DGMR.from_pretrained(str(tmp_path), **kw)
    st.save_file({**sd, "sampler.stray.weight": torch.zeros(2)}, path)
    with pytest.raises(RuntimeError, match=r"sampler\.stray\.weight"):
        DGMR.from_pretrained(str(tmp_path), **kw)
    st.save_file({**sd, "sampler.bn.bias": torch.zeros(3)}, path)
    with pytest.raises(RuntimeError, match=r"sampler\.bn\.bias"):
        DGMR.from_pretrained(str(tmp_path), **kw)
    with pytest.raises(FileNotFoundError):
        DGMR.from_pretrained("openclimatefix/dgmr", **kw)
    os.remove(path)
    with pytest.raises(FileNotFoundError, match="no weight file"):
        DGMR.from_pretrained(str(tmp_path), **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DGMR.from_pretrained(str(tmp_path))


# --- Lightning ----------------------------------------------------------------


@pytest.fixture(scope="module")
def lightning_ckpt(tmp_path_factory, port_model):
    """A reference-style .ckpt after one torch Adam step of each optimizer.

    The state dict lists the stacks in another order than the port's
    (sampler first), both at the top and under ``generator.*``, and each
    Adam iterates its parameters in that order, so a loader that mapped the
    optimizer state by the port's own parameter positions would scramble it.
    """
    model = DGMR(**TINY, **TOWERS, device="cpu")
    model.load_state_dict(port_model.state_dict())
    sd = model.state_dict()
    order = ("sampler", "latent_stack", "conditioning_stack")
    stacks = {k: v for name in order for k, v in sd.items() if k.startswith(name + ".")}
    disc = {k: v for k, v in sd.items() if k.startswith("discriminator.")}
    params = dict(model.named_parameters())
    g_params = [params[k] for k in stacks if k in params]
    d_params = [params[k] for k in disc if k in params]
    opt_g = torch.optim.Adam(g_params, lr=5e-5, betas=(0.0, 0.999))
    opt_d = torch.optim.Adam(d_params, lr=2e-4, betas=(0.0, 0.999))
    gen = torch.Generator().manual_seed(11)
    for p in g_params + d_params:
        p.grad = torch.randn(p.shape, generator=gen) * 1e-3
    opt_g.step()
    opt_d.step()
    sd = model.state_dict()
    ckpt_sd = {k: sd[k] for k in stacks}
    ckpt_sd.update({f"generator.{k}": sd[k] for k in stacks})
    ckpt_sd.update({k: sd[k] for k in disc})
    ckpt = {
        "state_dict": ckpt_sd,
        "hyper_parameters": dict(model.config),
        "optimizer_states": [opt_g.state_dict(), opt_d.state_dict()],
        "global_step": 7,
        "epoch": 0,
    }
    path = tmp_path_factory.mktemp("lightning") / "last.ckpt"
    torch.save(ckpt, str(path))
    moments = {name: opt.state[params[name]] for opt in (opt_g, opt_d)
               for name in params if params[name] in opt.state}
    return str(path), model, moments


def jax_init_state_without_compile(variables):
    """JAX's ``init_train_state`` over filled variables (its jitted init takes long)."""

    def init(model, rng, images, future_images, optimizers=None):
        g, d = jtraining.split_params(variables["params"])
        g_tx, d_tx = jtraining.make_optimizers(model)
        return jtraining.TrainState(
            params=variables["params"], batch_stats=variables["batch_stats"],
            spectral=variables["spectral"], g_opt_state=g_tx.init(g), d_opt_state=d_tx.init(d),
            step=np.zeros((), np.int32),
        )

    return init


def test_lightning_resume_matches_jax(lightning_ckpt, jax_side, monkeypatch):
    path, source, moments = lightning_ckpt
    model = DGMR(**TINY, **TOWERS, device="cpu")
    state, config = train_state_from_lightning(model, path)
    assert state.step == 7 and config == source.config
    assert_state_equal(model, source.state_dict())
    g_names = [n for n, _ in model.named_parameters() if not n.startswith("discriminator.")]
    assert len(state.g_opt.state) == len(g_names)
    for opt in (state.g_opt, state.d_opt):
        for p in opt.param_groups[0]["params"]:
            name = next(n for n, q in model.named_parameters() if q is p)
            for key in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(opt.state[p][key], moments[name][key]), (name, key)

    monkeypatch.setattr(jtraining, "init_train_state", jax_init_state_without_compile(jax_side[1]))
    jstate, jconfig = jax_train_state_from_lightning(JaxDGMR(**TINY, **TOWERS), path, None, None)
    assert int(jstate.step) == 7 and jconfig == config
    jparams = state_dict_from_variables(
        {"params": jstate.params, "batch_stats": jstate.batch_stats, "spectral": jstate.spectral})
    assert_state_equal(model, jparams)
    port_moments = {}
    for opt in (state.g_opt, state.d_opt):
        for name, p in model.named_parameters():
            if p in opt.state:
                port_moments[name] = opt.state[p]
    for jopt in (jstate.g_opt_state, jstate.d_opt_state):
        adam = jopt[0]
        assert isinstance(adam, optax.ScaleByAdamState) and int(adam.count) == 1
        for tree, key in ((adam.mu, "exp_avg"), (adam.nu, "exp_avg_sq")):
            sd = state_dict_from_variables({"params": tree, "spectral": jstate.spectral})
            for name, value in sd.items():
                if not name.endswith(("._u", "._v")):
                    np.testing.assert_array_equal(
                        np.array(port_moments[name][key]), np.asarray(value), err_msg=name)


def test_dgmr_from_lightning_ckpt(lightning_ckpt):
    path, source, _ = lightning_ckpt
    got = DGMR.from_pretrained(path, device="cpu", **TOWERS)
    assert not got.training
    assert_state_equal(got, source.state_dict())
