"""Ops and layers of the PyTorch port vs the JAX package, on the CPU.

Inputs are made from a seed with numpy and handed to both; per-op tolerances
are those of the JAX parity suite (rtol 2e-4 / atol 2e-5).
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skillful_nowcasting_tpu import ops as jops
from skillful_nowcasting_tpu.layers import AttentionLayer as JaxAttentionLayer
from skillful_nowcasting_tpu.ops import spectral_norm as jsn
from skillful_nowcasting_tpu_torch import ops
from skillful_nowcasting_tpu_torch.layers import AttentionLayer, get_conv_layer
from skillful_nowcasting_tpu_torch.ops import spectral_norm as sn
from torch_port_helpers import (
    ATOL,
    RTOL,
    jax_variables,
    load_port,
    nchw_to_nhwc,
    nhwc_to_nchw,
    randn,
    t,
)

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


def test_spectral_norm_functions_match_jax():
    rng = np.random.default_rng(0)
    kernel = randn(rng, 3, 3, 5, 7)  # HWIO
    u, v = randn(rng, 7), randn(rng, 45)
    wm = sn.kernel_to_weight_mat(t(kernel).permute(3, 2, 0, 1))  # OIHW gives torch's order
    np.testing.assert_array_equal(np.array(wm), np.array(jsn.kernel_to_weight_mat(kernel)))
    np.testing.assert_allclose(
        sn.spectral_sigma(wm, t(u), t(v)).item(),
        float(jsn.spectral_sigma(jnp.asarray(np.array(wm)), u, v)),
        rtol=1e-5,
    )
    pu, pv = sn.power_iteration(wm, t(u), t(v), 1e-12, n_iterations=3)
    ju, jv = jsn.power_iteration(jnp.asarray(np.array(wm)), u, v, 1e-12, n_iterations=3)
    np.testing.assert_allclose(np.array(pu), np.array(ju), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.array(pv), np.array(jv), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("kernel_size,padding", [(3, 1), (1, 0)])
def test_sn_conv_matches_jax(kernel_size, padding):
    x = randn(np.random.default_rng(1), 2, 6, 5, 4)
    jconv = jops.Conv(7, kernel_size=kernel_size, padding=padding, spectral_norm=True)
    variables = jax_variables(jconv, jnp.asarray(x), seed=3)
    want = jconv.apply(variables, jnp.asarray(x))
    conv = load_port(ops.conv2d(4, 7, kernel_size, padding=padding, spectral_norm=True), variables)
    with torch.no_grad():
        got = conv(nhwc_to_nchw(x))
    assert "parametrizations.weight.0._u" in conv.state_dict()
    np.testing.assert_allclose(nchw_to_nhwc(got), np.array(want), rtol=RTOL, atol=ATOL)


def test_spectral_norm_and_batchnorm_refuse_train_mode():
    """Train mode runs: a forward advances the state; reading ``.weight`` never does."""
    conv = ops.conv2d(3, 4, 3, padding=1, spectral_norm=True)
    bn = ops.BatchNorm2d(3)
    x = torch.randn(2, 3, 4, 4, generator=torch.Generator().manual_seed(0))
    norm = conv.parametrizations.weight[0]
    u0 = norm._u.clone()
    conv.weight, bn.running_mean  # plain reads
    assert torch.equal(norm._u, u0)
    assert conv(x).shape == (2, 4, 4, 4) and not torch.equal(norm._u, u0)
    assert bn(x).shape == x.shape and bn.running_mean.abs().sum() > 0
    conv.eval(), bn.eval()
    u1 = norm._u.clone()
    assert conv(x).shape == bn(x).shape[:1] + (4, 4, 4) and torch.equal(norm._u, u1)


def test_eval_batchnorm_matches_jax():
    x = randn(np.random.default_rng(2), 3, 5, 4, 6)
    jbn = jops.TorchBatchNorm()
    variables = jax_variables(jbn, jnp.asarray(x), seed=4)
    want = jbn.apply(variables, jnp.asarray(x), train=False)
    bn = load_port(ops.BatchNorm2d(6), variables)
    with torch.no_grad():
        got = bn(nhwc_to_nchw(x))
    np.testing.assert_allclose(nchw_to_nhwc(got), np.array(want), rtol=RTOL, atol=ATOL)


def test_pixel_pool_resize_match_jax():
    x = randn(np.random.default_rng(3), 2, 3, 8, 6, 5)  # (B, T, H, W, C) with a leading T
    xt = nhwc_to_nchw(x)  # (B, T, C, H, W)
    np.testing.assert_array_equal(
        nchw_to_nhwc(ops.space_to_depth(xt, 2)), np.array(jops.space_to_depth(jnp.asarray(x), 2))
    )
    y = randn(np.random.default_rng(4), 2, 4, 3, 8)
    np.testing.assert_array_equal(
        nchw_to_nhwc(ops.depth_to_space(nhwc_to_nchw(y), 2)),
        np.array(jops.depth_to_space(jnp.asarray(y), 2)),
    )
    x2 = x[0]  # (T, H, W, C) as a batch
    np.testing.assert_allclose(
        nchw_to_nhwc(ops.avg_pool(nhwc_to_nchw(x2), 2)),
        np.array(jops.avg_pool(jnp.asarray(x2), 2)),
        rtol=1e-6, atol=1e-7,
    )
    np.testing.assert_array_equal(
        nchw_to_nhwc(ops.upsample_nearest_2x(nhwc_to_nchw(x2))),
        np.array(jops.upsample_nearest_2x(jnp.asarray(x2))),
    )


@pytest.mark.parametrize("mode", ["torch_compat", "fixed"])
def test_attention_ops_match_jax(mode):
    rng = np.random.default_rng(5)
    q, k, v = (randn(rng, 2, 3, 5, 4) for _ in range(3))
    jfn = jops.attention_torch_compat if mode == "torch_compat" else jops.attention_fixed
    fn = ops.attention_torch_compat if mode == "torch_compat" else ops.attention_fixed
    want = jfn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = fn(nhwc_to_nchw(q), nhwc_to_nchw(k), nhwc_to_nchw(v))
    np.testing.assert_allclose(nchw_to_nhwc(got), np.array(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["torch_compat", "fixed"])
def test_attention_layer_matches_jax(mode):
    x = randn(np.random.default_rng(6), 2, 4, 4, 16)
    jlayer = JaxAttentionLayer(16, 16, mode=mode)
    variables = jax_variables(jlayer, jnp.asarray(x), seed=5)
    want = jlayer.apply(variables, jnp.asarray(x))
    layer = load_port(AttentionLayer(16, 16, mode=mode), variables)
    assert layer.gamma.item() == 0.5  # perturbed: the attention branch contributes
    with torch.no_grad():
        got = layer(nhwc_to_nchw(x))
    np.testing.assert_allclose(nchw_to_nhwc(got), np.array(want), rtol=RTOL, atol=ATOL)


def test_get_conv_layer_ports_standard_only():
    """"standard" and "3d" are ported; "coord" is not yet."""
    assert get_conv_layer("standard") is ops.conv2d
    assert get_conv_layer("3d") is ops.conv3d
    with pytest.raises(NotImplementedError):
        get_conv_layer("coord")
    with pytest.raises(ValueError):
        get_conv_layer("nope")


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import skillful_nowcasting_tpu_torch, skillful_nowcasting_tpu_torch.inference\n"
        "import skillful_nowcasting_tpu_torch.hub, skillful_nowcasting_tpu_torch.utils\n"
        "import skillful_nowcasting_tpu_torch.training, skillful_nowcasting_tpu_torch.losses\n"
        "import skillful_nowcasting_tpu_torch.models.discriminators\n"
        "import skillful_nowcasting_tpu_torch.metrics\n"
        "import skillful_nowcasting_tpu_torch.hub.pretrained\n"
        "import skillful_nowcasting_tpu_torch.hub.lightning\n"
        "import skillful_nowcasting_tpu_torch.hub.safetensors\n"
        "roots = ('jax', 'flax', 'skillful_nowcasting_tpu')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in roots]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
