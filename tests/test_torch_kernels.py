"""The port's two kernels on the CPU: plain versions vs the JAX Pallas kernels, and dispatch.

The Pallas kernels run in interpret mode on the CPU, as ``tests/test_pallas.py``
runs them; tolerances are theirs (rtol/atol 1e-5). The CUDA kernels themselves
are held against these plain versions on the card by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skillful_nowcasting_tpu.models.common import GBlock as JaxGBlock
from skillful_nowcasting_tpu.ops import pallas_gblock, pallas_gru
from skillful_nowcasting_tpu_torch import _build
from skillful_nowcasting_tpu_torch.models import GBlock
from skillful_nowcasting_tpu_torch.ops import (
    convgru_rollout,
    convgru_rollout_reference,
    fold_gblock_variables,
    gblock_fused,
)
from torch_port_helpers import jax_variables, load_port, randn, t

torch.set_num_threads(1)


def gru_inputs(rng, t_in, b, hw, c):
    s = (9 * c) ** -0.5
    return (
        randn(rng, t_in, b, hw, hw, 3 * c),
        randn(rng, b, hw, hw, c),
        randn(rng, 3, 3, c, 2 * c, scale=s),
        randn(rng, 3, 3, c, c, scale=s),
        randn(rng, 3 * c, scale=0.1),
    )


@pytest.mark.parametrize("static", [False, True])
def test_convgru_rollout_plain_matches_pallas(static):
    steps, b, hw, c = 4, 2, 8, 4
    args = gru_inputs(np.random.default_rng(0), 1 if static else steps, b, hw, c)
    want = pallas_gru.convgru_rollout(
        *map(jnp.asarray, args), n_steps=steps, interpret=True
    )
    got = convgru_rollout(*map(t, args), n_steps=steps)  # CPU tensors: the plain version
    assert got.shape == (steps, b, hw, hw, c)
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        np.array(got), np.array(convgru_rollout_reference(*map(t, args), n_steps=steps))
    )


@pytest.mark.parametrize("cin,cout", [(8, 8), (8, 12)])
def test_gblock_fused_plain_and_fold_match_pallas(cin, cout):
    x = randn(np.random.default_rng(1), 3, 16, 12, cin)
    variables = jax_variables(JaxGBlock(cin, cout), jnp.asarray(x), seed=2)
    jax_args = pallas_gblock.fold_gblock_variables(variables)
    want = pallas_gblock.gblock_fused(
        jnp.asarray(x), *jax_args[:-1], use_sc_conv=jax_args[-1], tile_rows=4, interpret=True
    )

    block = load_port(GBlock(cin, cout), variables)
    with torch.no_grad():
        args = fold_gblock_variables(block)
        got = gblock_fused(t(x), *args)
    assert args[-1] == jax_args[-1] == (cin != cout)
    for ours, theirs in zip(args[:-1], jax_args[:-1]):
        np.testing.assert_allclose(np.array(ours.detach()), np.array(theirs), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fn,n_args", [(convgru_rollout, 5), (gblock_fused, 9)])
def test_wrappers_refuse_non_cpu_tensors_without_a_kernel(fn, n_args):
    """Only CPU tensors take the plain version; any other device needs the kernel."""
    meta = [torch.empty(1, 1, 1, 1, 3, device="meta")] * n_args
    with pytest.raises(ValueError, match="CUDA device"):
        fn(*meta) if fn is convgru_rollout else fn(*meta, False)


def test_build_raises_clearly_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)  # no cached library
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library()
    assert not any(tmp_path.iterdir())
