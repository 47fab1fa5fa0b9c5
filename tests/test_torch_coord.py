"""The port's coord conv against the JAX package's, on the CPU.

``add_coords``' row and column channels are held at 1.2e-7 (one float32 ulp
at 1: XLA and the port round the linspace differently at some sizes), its
radial channel at 2.4e-7 (one ulp at 2, where it reaches 2.12: a coordinate's
last bit carries into it, and XLA:CPU's float32 sqrt alone differs from
torch's by up to 1.2e-7 on the same coordinates), ``CoordConv`` at the block
tolerance in eval and in train mode (spectral norm advancing), its gradients
at 1e-3 of each gradient's max-abs. Variables go from JAX to the port through
``state_dict_from_variables`` and ``load_state_dict(strict=True)``. The
blocks refuse ``conv_type="coord"``, which the JAX blocks cannot run.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skillful_nowcasting_tpu.layers import coord_conv as jcc
from skillful_nowcasting_tpu.layers.utils import get_conv_layer as jax_get_conv_layer
from skillful_nowcasting_tpu.models.common import ContextConditioningStack as JaxContextStack
from skillful_nowcasting_tpu.models.common import LBlock as JaxLBlock
from skillful_nowcasting_tpu_torch import DGMR
from skillful_nowcasting_tpu_torch.hub.safetensors import save_file
from skillful_nowcasting_tpu_torch.layers import CoordConv, add_coords, coord_conv2d, get_conv_layer
from skillful_nowcasting_tpu_torch.models.common import (
    ContextConditioningStack,
    DBlock,
    GBlock,
    LBlock,
    UpsampleGBlock,
)
from skillful_nowcasting_tpu_torch.models.discriminators import (
    Discriminator,
    SpatialDiscriminator,
    TemporalDiscriminator,
)
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
COORD_TOL = 1.2e-7
RADIUS_TOL = 2.4e-7
GRAD_TOL = 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_r", [False, True])
@pytest.mark.parametrize("hw", [(1, 1), (7, 7), (64, 64), (7, 64), (1, 7)])
def test_add_coords_matches_jax(hw, with_r, dtype):
    x = randn(np.random.default_rng(0), 2, 3, *hw)
    got = add_coords(t(x).to(getattr(torch, dtype)), with_r)
    want = jcc.add_coords(jnp.asarray(np.moveaxis(x, 1, -1), dtype=dtype), with_r)
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (2, 3 + 2 + int(with_r), *hw)
    got, want = got.float(), nhwc_to_nchw(np.asarray(want, np.float32))
    assert torch.equal(got[:, :3], want[:, :3])  # x passes through untouched
    assert (got[:, 3:5] - want[:, 3:5]).abs().max().item() <= COORD_TOL
    if with_r:
        assert (got[:, 5] - want[:, 5]).abs().max().item() <= RADIUS_TOL
    # row varies along H, column along W; a side of 1 gives zeros
    assert torch.equal(got[:, 3], got[:1, 3, :, :1].expand(2, *hw))
    assert torch.equal(got[:, 4], got[:1, 4, :1, :].expand(2, *hw))
    if hw[0] == 1:
        assert not got[:, 3].any()


def jax_coord(features, with_r, **conv_kwargs):
    return jcc.CoordConv(features=features, with_r=with_r, conv_kwargs=conv_kwargs)


@pytest.mark.parametrize("with_r", [False, True])
def test_coord_conv_matches_jax_eval_and_train(with_r):
    """Eval, and one train forward: the output, SN's u / v (advanced once) and the gradients."""
    x = randn(np.random.default_rng(1), 2, 9, 10, 4)  # NHWC
    kw = dict(kernel_size=3, padding=1, spectral_norm=True)
    jmod = jax_coord(5, with_r, **kw)
    variables = jax_variables(jmod, jnp.asarray(x), seed=4)
    port = load_port(CoordConv(4, 5, with_r, **kw), variables)
    assert port.conv.in_channels == 6 + int(with_r)
    np.testing.assert_allclose(nchw_to_nhwc(port(nhwc_to_nchw(x))),
                               np.array(jmod.apply(variables, jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)

    weights = randn(np.random.default_rng(2), 2, 9, 10, 5)

    def jax_train(params, xx):
        out, mut = jmod.apply({**variables, "params": params}, xx, update_stats=True,
                              mutable=["spectral"])
        return (out * weights).sum(), (out, mut["spectral"]["conv"]["uv"])

    (_, (jout, (ju, jv))), (jgp, jgx) = jax.jit(
        jax.value_and_grad(jax_train, argnums=(0, 1), has_aux=True)
    )(variables["params"], jnp.asarray(x))

    port.train()
    par = port.conv.parametrizations.weight
    u0, v0 = par[0]._u.clone(), par[0]._v.clone()
    xt = nhwc_to_nchw(x).requires_grad_()
    out = port(xt)
    (out * nhwc_to_nchw(weights)).sum().backward()
    np.testing.assert_allclose(nchw_to_nhwc(out), np.array(jout), rtol=RTOL, atol=ATOL)
    # exactly one power iteration from the stored vectors, as JAX's update_stats
    u1, v1 = sn.power_iteration(sn.kernel_to_weight_mat(par.original.detach()), u0, v0, 1e-12)
    for got, want, one in ((par[0]._u, ju, u1), (par[0]._v, jv, v1)):
        np.testing.assert_allclose(np.array(got), np.array(want), rtol=RTOL, atol=ATOL)
        assert torch.equal(got, one)
    grads = ((xt.grad, nhwc_to_nchw(np.array(jgx))),
             (par.original.grad, t(np.transpose(np.array(jgp["conv"]["kernel"]), (3, 2, 0, 1)))),
             (port.conv.bias.grad, t(jgp["conv"]["bias"])))
    for got, want in grads:
        scale = want.abs().max().item()
        assert scale > 0 and (got - want).abs().max().item() <= GRAD_TOL * scale


def test_get_conv_layer_coord_and_lblock_match_jax():
    """The factory gives a CoordConv with conv2d's signature; LBlock takes it in both packages."""
    assert get_conv_layer("coord") is coord_conv2d
    x = randn(np.random.default_rng(3), 2, 8, 8, 4)
    jmod = jax_get_conv_layer("coord")(6, kernel_size=1, spectral_norm=True, name="c")
    variables = jax_variables(jmod, jnp.asarray(x), seed=5)
    port = load_port(get_conv_layer("coord")(4, 6, 1, spectral_norm=True), variables)
    assert isinstance(port, CoordConv) and not port.with_r and port.conv.kernel_size == (1, 1)
    np.testing.assert_allclose(nchw_to_nhwc(port(nhwc_to_nchw(x))),
                               np.array(jmod.apply(variables, jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)

    jblock = JaxLBlock(4, 8, conv_type="coord")
    variables = jax_variables(jblock, jnp.asarray(x), seed=6)
    block = load_port(LBlock(4, 8, "coord"), variables)
    np.testing.assert_allclose(nchw_to_nhwc(block(nhwc_to_nchw(x))),
                               np.array(jblock.apply(variables, jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)


def test_coord_blocks_are_refused_as_jax_cannot_run_them(tmp_path):
    """JAX's CoordConv takes no `sequential`: its context stack fails at init; the port refuses."""
    x = jnp.zeros((1, 4, 16, 16, 1))
    with pytest.raises(TypeError, match="sequential"):
        JaxContextStack(input_channels=1, output_channels=32, conv_type="coord").init(
            jax.random.key(0), x)

    refused = [
        lambda: GBlock(8, 8, "coord"),
        lambda: UpsampleGBlock(8, 4, "coord"),
        lambda: DBlock(8, 16, "coord"),
        lambda: ContextConditioningStack(1, 32, conv_type="coord"),
        lambda: SpatialDiscriminator(1, conv_type="coord"),
        lambda: TemporalDiscriminator(1, conv_type="coord"),
        lambda: Discriminator(1, conv_type="coord"),
        lambda: DGMR(conv_type="coord", device="cpu"),
        lambda: DGMR(conv_type="coord"),  # refused before the device is looked at
    ]
    for build in refused:
        with pytest.raises(TypeError, match="conv_type='coord'"):
            build()
    (tmp_path / "config.json").write_text(json.dumps({"conv_type": "coord"}))
    save_file({"unused": torch.zeros(1)}, str(tmp_path / "model.safetensors"))
    with pytest.raises(TypeError, match="DGMR\\(conv_type='coord'\\)"):
        DGMR.from_pretrained(str(tmp_path), device="cpu")
