"""The port's serving artifact (``serving.py``) against the JAX package's contract, on the CPU.

Follows ``tests/test_serving.py`` at a tiny config: export -> save -> load ->
replay. The loaded artifact reproduces the port's ``make_generate``
bit-for-bit (the same ops on the same platform), and JAX's ``make_generate``
within 1e-4 (the port's end-to-end tiny-generator bound) when it is handed
JAX's own latents for the same key (threefry and Philox never agree, so the
latents are recovered from the JAX key and replace the artifact's draw).
Weights are program arguments; the latent-RNG record and the device type are
enforced; a bf16 artifact keeps an f32 interface within 0.15 of the f32
scale (the JAX suite's bf16 bar); the custom ops pass
``torch.library.opcheck``; serving an artifact imports no model code.

The JAX reference (variables, batch, latents, nowcast) is computed once per
test run and shared by every xdist worker (``run_once``).
"""

import copy
import json
import subprocess
import sys
import zipfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skillful_nowcasting_tpu import DGMR as JaxDGMR
from skillful_nowcasting_tpu.hub.pretrained import abstract_variables
from skillful_nowcasting_tpu.inference import make_generate as jax_make_generate
from skillful_nowcasting_tpu.utils import random_fill_variables
from skillful_nowcasting_tpu_torch import DGMR, serving
from skillful_nowcasting_tpu_torch.hub import load_variables
from skillful_nowcasting_tpu_torch.inference import make_generate
from torch_port_helpers import jax_latents, perturb, run_once, t

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TINY = dict(forecast_steps=2, output_shape=64, latent_channels=256, context_channels=32,
            generation_steps=1, num_samples=2, num_spatial_layers=2, num_temporal_layers=2)
BATCH, MICROBATCH, SEED = 3, 2, 7  # a ragged last chunk: 2 + 1
TOL = 1e-4
BF16_TOL = 0.15


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Tiny variables, a batch (NCHW), JAX's latents for key(SEED) (NCHW) and its nowcast."""

    def start():
        jmodel = JaxDGMR(**TINY)
        variables = perturb(
            jax.tree.map(np.array, random_fill_variables(abstract_variables(jmodel), 0)), 1)
        x = np.random.default_rng(11).random((BATCH, 4, 64, 64, 1), np.float32)
        key = jax.random.key(SEED)
        want = jax_make_generate(jmodel, microbatch=MICROBATCH)(variables, jnp.asarray(x), key)
        z = jax_latents(jmodel, variables, jax.random.split(key, TINY["num_samples"]))
        out = {"variables": variables, "x": np.moveaxis(x, -1, 2), "z": z,
               "want": np.moveaxis(np.asarray(want), -1, 3)}
        return lambda: out

    return run_once(tmp_path_factory, "test_torch_serving_jax", start)[0]


@pytest.fixture(scope="module")
def port(reference):
    model = DGMR(**TINY, device="cpu")
    assert load_variables(model, reference["variables"]) == 0
    return model.eval()


@pytest.fixture(scope="module")
def artifact(port, tmp_path_factory):
    path = tmp_path_factory.mktemp("serving") / "tiny.dgmrx"
    meta = serving.save_exported(str(path), port, batch_size=BATCH, microbatch=MICROBATCH)
    return str(path), meta


@pytest.fixture(scope="module")
def loaded(artifact):
    return serving.load_exported(artifact[0]).place("cpu")


def fresh(server):
    """The loaded program with its own copies of the weight list and meta (tests edit both)."""
    return serving.NowcastServer(server.call, list(server.weights), copy.deepcopy(server.meta))


def test_export_roundtrip_exact(reference, port, artifact, loaded, monkeypatch):
    path, meta = artifact
    assert meta["artifact_version"] == serving.ARTIFACT_VERSION == 1
    assert meta["config"]["output_shape"] == 64
    assert meta["output_shape"] == [2, BATCH, 2, 1, 64, 64]
    assert meta["input_shape"] == [BATCH, 4, 1, 64, 64]
    assert meta["compute_dtype"] is None  # a JSON null, not the string "None"
    assert json.loads(json.dumps(meta))["compute_dtype"] is None
    assert meta["device_type"] == "cpu"
    assert meta["latent_rng"] == serving.latent_record(2, (8, 2, 2))
    assert meta["design"] == serving.DESIGN

    server = fresh(loaded)
    x = reference["x"]
    out = server.generate(x, seed=SEED)
    assert tuple(out.shape) == tuple(meta["output_shape"]) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())
    # Bit-exact vs the in-process path (same ops, same platform), ragged chunk included.
    direct = make_generate(port, microbatch=MICROBATCH)(t(x), torch.Generator().manual_seed(SEED))
    assert torch.equal(out, direct)

    # Against JAX's make_generate, handed JAX's own latents for the same key.
    monkeypatch.setattr(serving, "draw_latents", lambda n, shape, seed: t(reference["z"]))
    got = server.generate(x, seed=SEED)
    np.testing.assert_allclose(np.array(got), reference["want"], rtol=0, atol=TOL)


def test_export_microbatch_and_weight_update(reference, artifact, loaded):
    """Weights are program arguments: replacing one changes the nowcast without a new export."""
    meta = artifact[1]
    server = fresh(loaded)
    x = reference["x"]
    out = server.generate(x, seed=1)
    assert tuple(out.shape) == (2, BATCH, 2, 1, 64, 64)
    names = meta["param_names"]
    gen_idx = [i for i, n in enumerate(names) if n.startswith("sampler.")]
    assert gen_idx and not any(n.startswith("discriminator.") for n in names)
    idx = max(gen_idx, key=lambda i: server.weights[i].numel())
    server.weights[idx] = server.weights[idx] + 0.05
    assert (server.generate(x, seed=1) - out).abs().max().item() > 0


@pytest.mark.parametrize("form", ["bfloat16 tensor", "float32 tensor"])
def test_generate_takes_tensors(reference, loaded, form):
    """A tensor ``x`` of any float dtype gives the bits of the equal float32 numpy ``x``."""
    server = fresh(loaded)
    x = torch.from_numpy(reference["x"]).bfloat16()  # values a bf16 batch can hold exactly
    want = server.generate(x.float().numpy(), seed=SEED)
    got = server.generate(x if form == "bfloat16 tensor" else x.float(), seed=SEED)
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_weight_count_is_checked(artifact, tmp_path):
    """Weights are indexed by position; a count that differs from the names raises."""
    path, _ = artifact
    bad = tmp_path / "bad.dgmrx"
    with zipfile.ZipFile(path) as src, zipfile.ZipFile(bad, "w") as dst:
        for item in src.namelist():
            data = src.read(item)
            if item == "meta.json":
                meta = json.loads(data)
                meta["param_names"] = meta["param_names"][:-1]
                data = json.dumps(meta)
            dst.writestr(item, data)
    with pytest.raises(ValueError, match="weight count"):
        serving.load_exported(str(bad))


def test_latent_record_and_device_type_enforced(reference, loaded):
    """generate() draws latents by the recorded contract; a record that disagrees raises."""
    server = fresh(loaded)
    x = reference["x"]
    assert server.generate(x, seed=0).shape == (2, BATCH, 2, 1, 64, 64)

    server.meta["latent_rng"] = dict(server.meta["latent_rng"], generator="torch.Generator('cuda')")
    with pytest.raises(ValueError, match="latent_rng"):
        server.generate(x, seed=0)

    server = fresh(loaded)
    server.meta["device_type"] = "cuda"
    with pytest.raises(ValueError, match="'cuda'.*'cpu'"):
        server.generate(x, seed=0)


def test_export_bf16_compute(reference, port, tmp_path):
    """compute_dtype=bfloat16: f32 interface, finite, close to the f32 nowcast."""
    path = str(tmp_path / "tiny_bf16.dgmrx")
    meta = serving.save_exported(path, port, batch_size=1, microbatch=None,
                                 compute_dtype=torch.bfloat16)
    assert meta["compute_dtype"] == "bfloat16"
    server = serving.load_exported(path).place("cpu")
    x = reference["x"][:1]
    out = server.generate(x, seed=2)
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    ref = make_generate(port)(t(x), torch.Generator().manual_seed(2))
    scale = max(ref.abs().max().item(), 1e-3)
    assert (out - ref).abs().max().item() / scale < BF16_TOL


def _op_args(dtype):
    rng = np.random.default_rng(5)

    def r(*shape, scale=1.0, dt=dtype):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dt)

    c, cin, cout = 4, 6, 4
    rollout = (r(3, 1, 4, 4, 3 * c), r(1, 4, 4, c), r(3, 3, c, 2 * c, scale=0.2),
               r(3, 3, c, c, scale=0.2), r(3 * c, scale=0.1), 3)
    gblock = (r(2, 5, 5, cin), r(3, 3, cin, cin, scale=0.2), r(3, 3, cin, cout, scale=0.2),
              r(1, 1, cin, cout, scale=0.3), r(cin, dt=torch.float32), r(cin, dt=torch.float32),
              r(cin, dt=torch.float32), r(cin, dt=torch.float32), r(cout, dt=torch.float32), True)
    upsample = (r(2, 3, 4, cin), *gblock[1:-1])
    return {"convgru_rollout": rollout, "gblock_fused": gblock, "upsample_gblock_fused": upsample}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["convgru_rollout", "gblock_fused", "upsample_gblock_fused"])
def test_custom_ops_pass_opcheck(op, dtype):
    """Schema, fake (meta) implementation and AOT dispatch of the custom ops."""
    torch.library.opcheck(getattr(torch.ops.dgmr, op).default, _op_args(dtype)[op])


def test_serving_imports_no_model_code(reference, artifact):
    """Loading and serving an artifact needs torch, numpy and the port's ops only."""
    path, _ = artifact
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from skillful_nowcasting_tpu_torch.serving import load_exported\n"
        f"server = load_exported({path!r}).place('cpu')\n"
        f"out = server.generate(np.zeros({tuple(reference['x'].shape)}, np.float32), seed=0)\n"
        "assert tuple(out.shape) == tuple(server.meta['output_shape'])\n"
        "bad = [m for m in sys.modules if m.startswith('skillful_nowcasting_tpu_torch.models')\n"
        "       or m.split('.')[0] in ('jax', 'flax', 'skillful_nowcasting_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=300)
