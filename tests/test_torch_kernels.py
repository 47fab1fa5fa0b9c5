"""The port's two kernels on the CPU: plain versions vs the JAX Pallas kernels, and dispatch.

The Pallas kernels run in interpret mode on the CPU, as ``tests/test_pallas.py``
runs them; tolerances are theirs (rtol/atol 1e-5). The CUDA kernels themselves
are held against these plain versions on the card by ``tests/test_torch_cuda.py``.
"""

import importlib

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
    gblock_fused_reference,
)
from skillful_nowcasting_tpu_torch.ops import gru_rollout as gru_rollout_mod
from torch_port_helpers import jax_variables, load_port, randn, t

gblock_fused_mod = importlib.import_module("skillful_nowcasting_tpu_torch.ops.gblock_fused")

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


@pytest.mark.parametrize("kernel", ["convgru_rollout", "gblock_fused"])
def test_bf16_channel_padding_is_exact(kernel):
    """The bf16 wrappers' zero padding to multiples of 8 leaves the first C channels as they were.

    In float64, where the padded zeros' only effect is on the summation
    order, the padded problem's plain version agrees with the original's.
    """
    rng = np.random.default_rng(9)
    if kernel == "convgru_rollout":
        args = [a.double() for a in map(t, gru_inputs(rng, 3, 2, 5, 6))]
        padded = gru_rollout_mod.pad_channels(*args)
        assert padded[-1] == 8 and padded[0].shape == (3, 2, 5, 5, 24)
        want = convgru_rollout_reference(*args, n_steps=3)
        got = convgru_rollout_reference(*padded[:-1], n_steps=3)
        assert got[..., 6:].abs().max().item() == 0.0
    else:
        x = randn(rng, 3, 7, 5, 6)
        k = [randn(rng, 3, 3, 6, 6, scale=0.2), randn(rng, 3, 3, 6, 12, scale=0.2),
             randn(rng, 1, 1, 6, 12, scale=0.4)]
        aff = [1.0 + randn(rng, 6, scale=0.1), randn(rng, 6, scale=0.1),
               1.0 + randn(rng, 6, scale=0.1), randn(rng, 6, scale=0.1), randn(rng, 12, scale=0.1)]
        args = [t(a).double() for a in (x, *k, *aff)]
        padded = gblock_fused_mod.pad_channels(*args)
        assert padded[0].shape == (3, 7, 5, 8) and padded[2].shape == (3, 3, 8, 16)
        want = gblock_fused_reference(*args, True)
        got = gblock_fused_reference(*padded, True)
        assert got[..., 12:].abs().max().item() == 0.0
    np.testing.assert_allclose(np.array(got[..., :want.shape[-1]]), np.array(want),
                               rtol=0, atol=1e-12)


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
