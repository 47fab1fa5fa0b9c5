"""The port's reader and writer of the JAX package's native format vs the JAX package and flax.

On the CPU, at the tiny config of ``tests/test_torch_hub.py``, with no JAX
jit and no forward: the hub tests already tie ``state_dict_from_variables``
to matching forwards, so equality of state is the parity here. The codec
(``hub/msgpack.py``) is held byte for byte against the ``msgpack`` package;
directories written by the JAX package's ``BoundModel.save_pretrained`` load
into the port bit for bit; the port's ``save_checkpoint`` directories load
in the JAX package leaf for leaf and are byte-equal to what flax writes.
"""

import filecmp
import os

import flax.serialization as flax_ser
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from skillful_nowcasting_tpu import DGMR as JaxDGMR
from skillful_nowcasting_tpu import models as jmodels
from skillful_nowcasting_tpu.hub import build_module as jax_build_module
from skillful_nowcasting_tpu.hub import load_checkpoint as jax_load_checkpoint
from skillful_nowcasting_tpu.hub.pretrained import BoundModel, abstract_variables
from skillful_nowcasting_tpu.hub.serialization import np_tree
from skillful_nowcasting_tpu.utils import random_fill_variables
from skillful_nowcasting_tpu_torch import DGMR, models
from skillful_nowcasting_tpu_torch.hub import (
    compose_generator,
    convert_torch_state_dict,
    load_checkpoint,
    module_config,
    save_checkpoint,
    state_dict_from_variables,
)
from skillful_nowcasting_tpu_torch.hub import msgpack as port_msgpack
from skillful_nowcasting_tpu_torch.hub import pretrained, serialization
from torch_port_helpers import perturb, run_once

torch.set_num_threads(1)

TINY = dict(forecast_steps=2, output_shape=64, latent_channels=256, context_channels=32)
TOWERS = dict(num_spatial_layers=2, num_temporal_layers=2)  # kept out of config.json, as in JAX
WEIGHTS = serialization.FLAX_WEIGHTS_NAME


@pytest.fixture(scope="module")
def variables(tmp_path_factory):
    """The JAX DGMR's filled + perturbed numpy variable tree, built once per test run."""

    def start():
        abstract = abstract_variables(JaxDGMR(**TINY, **TOWERS))
        return lambda: perturb(jax.tree.map(np.array, random_fill_variables(abstract, 0)), 1)

    return run_once(tmp_path_factory, "test_torch_serialization_variables", start)[0]


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory, variables):
    """A directory written by the JAX package's ``BoundModel.save_pretrained``."""
    model = JaxDGMR(**TINY, **TOWERS)
    path = str(tmp_path_factory.mktemp("jax_dgmr"))
    BoundModel(model, variables, model.config).save_pretrained(path)
    return path


@pytest.fixture(scope="module")
def port_model(jax_dir):
    return DGMR.from_pretrained(jax_dir, device="cpu", **TOWERS)


def assert_state_equal(got: torch.nn.Module, want: dict):
    sd = got.state_dict()
    assert set(sd) == set(want)
    for k, v in want.items():
        assert sd[k].dtype == v.dtype and torch.equal(sd[k], v), k


def assert_trees_equal(got, want):
    """The same structure (tuples where ``want`` has them); each leaf's shape, dtype, value."""
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(want)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (path, a.shape, b.shape, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def subtree(tree, *keys):
    """``{collection: tree[collection][keys...]}`` over the collections that hold ``keys``."""
    out = {}
    for name, coll in tree.items():
        for k in keys:
            coll = coll.get(k) if isinstance(coll, dict) else None
        if coll:
            out[name] = coll
    return out


# --- the codec against the msgpack package -------------------------------------


def codec_sample(rng, ext_type, entries):
    """A seeded tree whose items cross every width boundary of the msgpack spec.

    ``entries``: the lengths of its arrays and maps (65536 takes the 32-bit forms).
    """
    ints = [0, 1, -1]
    for k in (5, 7, 8, 15, 16, 31, 32, 63):
        ints += [2**k - 1, 2**k, -(2**k), -(2**k) - 1]
    ints = [i for i in ints if -(2**63) <= i < 2**64] + [2**64 - 1]

    def text(n):
        return rng.integers(ord("a"), ord("z") + 1, n, dtype=np.uint8).tobytes().decode()

    sizes = (0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536)
    return {
        "ints": ints,
        "floats": [0.0, -0.0, 1.5, -2.25e300, float(rng.standard_normal()), float("inf")],
        "consts": [None, True, False],
        "strs": [text(n) for n in sizes] + ["é" * 20, "雨" * 11],
        "bins": [rng.bytes(n) for n in sizes],
        "arrays": {str(n): [int(v) for v in rng.integers(-300, 300, n)] for n in entries},
        "maps": {str(n): {f"{prefix}.{i}": i for i in range(n)}
                 for n, prefix in ((n, text(n % 40)) for n in entries)},
        "exts": [ext_type(int(rng.integers(0, 128)), rng.bytes(n))
                 for n in (1, 2, 3, 4, 8, 16, 17, 255, 256, 65535, 65536)],
        "tuple": (1, "two", (3.0, None)),
        "nested": [[[{"deep": [b"\x00"]}]]],
    }


@pytest.mark.parametrize("seed,entries", [(0, (15, 16)), (1, (15, 16)), (2, (15, 16, 65536))])
def test_codec_matches_msgpack(seed, entries):
    ours = port_msgpack.packb(
        codec_sample(np.random.default_rng(seed), port_msgpack.ExtType, entries))
    theirs = msgpack.packb(codec_sample(np.random.default_rng(seed), msgpack.ExtType, entries),
                           use_bin_type=True)
    assert ours == theirs
    assert port_msgpack.unpackb(theirs) == msgpack.unpackb(theirs, raw=False)
    single = msgpack.packb([1.5, -3.0e-5, float(seed)], use_single_float=True)  # float32s
    assert port_msgpack.unpackb(single) == msgpack.unpackb(single)
    hooked = port_msgpack.unpackb(theirs, ext_hook=lambda code, data: (code, bytes(data)))
    assert hooked["exts"] == [(e.code, e.data) for e in msgpack.unpackb(theirs)["exts"]]


@pytest.mark.parametrize("data,match", [
    (msgpack.packb({"a": [1, 2, b"xyz"]})[:-2], "truncated at offset 8"),
    (b"\xda\x00\x05ab", "truncated at offset 3: 5 bytes wanted, 2 left"),
    (b"\x92\x01\xc1", "unknown type byte 0xc1 at offset 2"),
    (b"\x01\x02", "1 trailing bytes at offset 1"),
    (b"\x81\x01\x02", "map key of type int at offset 1"),
    (b"\x91" * 600 + b"\x00", "nesting deeper than 512"),
])
def test_codec_refuses_malformed(data, match):
    with pytest.raises(ValueError, match=match):
        port_msgpack.unpackb(data)


# --- JAX-written directories into the port ----------------------------------------


def test_jax_dgmr_loads_in_port(port_model, variables):
    assert not port_model.training and port_model.forecast_steps == TINY["forecast_steps"]
    assert_state_equal(port_model, state_dict_from_variables(variables))


def test_jax_stacks_load_in_port(tmp_path, port_model, variables):
    parts = {}
    for name, cls, jcls in (
        ("conditioning_stack", models.ContextConditioningStack, jmodels.ContextConditioningStack),
        ("latent_stack", models.LatentConditioningStack, jmodels.LatentConditioningStack),
        ("sampler", models.Sampler, jmodels.Sampler),
    ):
        jmodule = jax_build_module(jcls, module_config(getattr(port_model, name)))
        part = subtree(variables, name)
        BoundModel(jmodule, part, module_config(getattr(port_model, name))).save_pretrained(
            str(tmp_path / name))
        parts[name] = cls.from_pretrained(str(tmp_path / name), device="cpu")
        assert_state_equal(parts[name], state_dict_from_variables(part))
    gen = compose_generator(parts["conditioning_stack"], parts["latent_stack"], parts["sampler"])
    want = {k: v for k, v in port_model.state_dict().items() if not k.startswith("discriminator.")}
    assert_state_equal(gen, want)


@pytest.mark.parametrize("cls,jcls,kwargs,keys", [
    (models.Discriminator, jmodels.Discriminator, dict(input_channels=1, **TOWERS),
     ("discriminator",)),
    (models.SpatialDiscriminator, jmodels.SpatialDiscriminator,
     dict(input_channels=1, num_layers=2), ("discriminator", "spatial_discriminator")),
    (models.TemporalDiscriminator, jmodels.TemporalDiscriminator,
     dict(input_channels=1, num_layers=2), ("discriminator", "temporal_discriminator")),
])
def test_jax_discriminators_load_in_port(tmp_path, variables, cls, jcls, kwargs, keys):
    jmodule = jcls(**kwargs)
    part = subtree(variables, *keys)
    BoundModel(jmodule, part, kwargs).save_pretrained(str(tmp_path))
    got = cls.from_pretrained(str(tmp_path), device="cpu")
    assert_state_equal(got, state_dict_from_variables(part))


# --- the port's files into JAX, and flax's bytes ------------------------------------


def test_port_checkpoint_loads_in_jax(tmp_path, port_model, variables, jax_dir):
    nbytes = pretrained.save_checkpoint(port_model, str(tmp_path))
    assert nbytes == os.path.getsize(tmp_path / WEIGHTS)
    # What the JAX package's BoundModel.save_pretrained wrote for the same weights, byte for byte.
    for name in (serialization.CONFIG_NAME, WEIGHTS):
        assert filecmp.cmp(tmp_path / name, os.path.join(jax_dir, name), shallow=False), name
    config, loaded = jax_load_checkpoint(str(tmp_path))
    assert config == port_model.config
    assert_trees_equal(loaded, variables)  # each spectral uv a (u, v) tuple, as in `variables`
    bound = JaxDGMR.from_pretrained(str(tmp_path), **TOWERS)
    assert bound.module.forecast_steps == TINY["forecast_steps"]
    assert_trees_equal(jax.tree.map(np.asarray, bound.variables), variables)
    assert_trees_equal(convert_torch_state_dict(port_model.state_dict()), variables)


def test_save_checkpoint_bytes_equal_flax(tmp_path, variables):
    nbytes = save_checkpoint(str(tmp_path), {"a": 1}, variables)
    assert nbytes == os.path.getsize(tmp_path / WEIGHTS)
    want = flax_ser.msgpack_serialize(flax_ser.to_state_dict(np_tree(variables)))
    assert (tmp_path / WEIGHTS).read_bytes() == want
    config, back = load_checkpoint(str(tmp_path))
    assert config == {"a": 1}
    assert_trees_equal(back, variables)


def bf16_bits(n: int) -> np.ndarray:
    return np.random.default_rng(7).integers(0, 2**16, n, dtype=np.uint16)


@pytest.mark.parametrize("leaf", ["chunked", "bfloat16", "npscalar"])
def test_edge_leaves_match_flax(monkeypatch, leaf):
    rng = np.random.default_rng(3)
    if leaf == "chunked":  # 400 bytes above a 64-byte limit: 7 chunks of 16 floats
        monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", 64)
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
        tree = {"w": rng.standard_normal((10, 10)).astype(np.float32), "b": np.ones(4, np.int8)}
        ours, want = tree, tree
    elif leaf == "bfloat16":
        bits = bf16_bits(12).reshape(3, 4)
        bits[bits & 0x7F80 == 0x7F80] = 0x3F80  # no NaN: compared by value below
        ours = {"h": torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)}
        tree = {"h": bits.view(jnp.bfloat16)}
        want = {"h": (bits.astype(np.uint32) << 16).view(np.float32)}
    else:
        tree = {"f": np.float32(1.5), "d": np.float64(-2.0), "i": np.int64(3),
                "t": np.bool_(True), "c": 1 - 2j}
        ours, want = tree, tree
    data = flax_ser.msgpack_serialize(tree)
    assert serialization.msgpack_serialize(ours) == data
    got = serialization.msgpack_restore(data)
    assert set(got) == set(want)
    for k in want:
        assert type(got[k]) is type(want[k]), k
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    back = flax_ser.msgpack_restore(serialization.msgpack_serialize(ours))
    for k in tree:  # flax reads the port's bytes back bit for bit, in its own dtypes
        a, b = np.asarray(back[k]), np.asarray(tree[k])
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), k


# --- which file loads, and what a bad one does ----------------------------------------


def test_msgpack_loads_before_safetensors(tmp_path, port_model, jax_dir):
    other = DGMR.from_pretrained(jax_dir, device="cpu", **TOWERS)
    with torch.no_grad():
        other.sampler.g1.bn1.running_var.mul_(2)
    other.save_pretrained(str(tmp_path))
    pretrained.save_checkpoint(port_model, str(tmp_path))
    got = DGMR.from_pretrained(str(tmp_path), device="cpu", **TOWERS)
    assert_state_equal(got, port_model.state_dict())
    os.remove(tmp_path / WEIGHTS)
    assert_state_equal(DGMR.from_pretrained(str(tmp_path), device="cpu", **TOWERS),
                       other.state_dict())


@pytest.mark.parametrize("fault", ["truncated", "ext_code", "missing"])
def test_bad_msgpack_raises(tmp_path, port_model, variables, fault):
    """A bad file raises, though a good ``model.safetensors`` lies beside it: no fallback."""
    port_model.save_pretrained(str(tmp_path))
    kw = dict(device="cpu", **TOWERS)
    if fault == "truncated":
        pretrained.save_checkpoint(port_model, str(tmp_path))
        data = (tmp_path / WEIGHTS).read_bytes()
        (tmp_path / WEIGHTS).write_bytes(data[: len(data) // 2])
        error, match = ValueError, "truncated at offset"
    elif fault == "ext_code":
        save_checkpoint(str(tmp_path), port_model.config, {})
        (tmp_path / WEIGHTS).write_bytes(
            msgpack.packb({"params": msgpack.ExtType(9, b"\x00" * 4)}))
        error, match = ValueError, "unknown msgpack ext code 9"
    else:
        tree = jax.tree.map(lambda a: a, variables)
        del tree["batch_stats"]["sampler"]["g1"]["bn1"]["mean"]
        save_checkpoint(str(tmp_path), port_model.config, tree)
        error, match = RuntimeError, r"sampler\.g1\.bn1\.running_mean"
    with pytest.raises(error, match=match):
        DGMR.from_pretrained(str(tmp_path), **kw)
