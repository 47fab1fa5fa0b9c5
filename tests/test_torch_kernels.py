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
    upsample_gblock_fused,
)
from skillful_nowcasting_tpu_torch.ops import gru_rollout as gru_rollout_mod
from skillful_nowcasting_tpu_torch.ops import tma
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


@pytest.mark.parametrize("kernel", ["convgru_rollout", "gblock_fused"])
def test_f32_channel_padding_is_exact(kernel):
    """The f32 wrappers' zero padding is exact: the GBlock's to multiples of 4 (TMA's 16-byte
    strides), the rollout's to multiples of 16 (its gate epilogue's blocks).

    As for bf16: in float64 the padded problem's plain version agrees with
    the original's, and every padded output channel is exactly 0.
    """
    rng = np.random.default_rng(10)
    if kernel == "convgru_rollout":
        args = [a.double() for a in map(t, gru_inputs(rng, 3, 2, 5, 10))]
        padded = gru_rollout_mod.pad_channels(*args, multiple=16)
        assert padded[-1] == 16 and padded[0].shape == (3, 2, 5, 5, 48)
        assert padded[2].shape == (3, 3, 16, 32) and padded[3].shape == (3, 3, 16, 16)
        want = convgru_rollout_reference(*args, n_steps=3)
        got = convgru_rollout_reference(*padded[:-1], n_steps=3)
        assert got[..., 10:].abs().max().item() == 0.0
    else:
        x = randn(rng, 3, 7, 5, 10)
        k = [randn(rng, 3, 3, 10, 10, scale=0.2), randn(rng, 3, 3, 10, 6, scale=0.2),
             randn(rng, 1, 1, 10, 6, scale=0.4)]
        aff = [1.0 + randn(rng, 10, scale=0.1), randn(rng, 10, scale=0.1),
               1.0 + randn(rng, 10, scale=0.1), randn(rng, 10, scale=0.1), randn(rng, 6, scale=0.1)]
        args = [t(a).double() for a in (x, *k, *aff)]
        padded = gblock_fused_mod.pad_channels(*args, multiple=4)
        assert padded[0].shape == (3, 7, 5, 12) and padded[2].shape == (3, 3, 12, 8)
        want = gblock_fused_reference(*args, True)
        got = gblock_fused_reference(*padded, True)
        assert got[..., 6:].abs().max().item() == 0.0
    np.testing.assert_allclose(np.array(got[..., :want.shape[-1]]), np.array(want),
                               rtol=0, atol=1e-12)


def split_tf32_numpy(w):
    """``csrc/hopper.cuh:split_tf32`` in numpy: clear the low 13 mantissa bits, twice."""
    mask = np.uint32(0xFFFFE000)
    hi = (w.view(np.uint32) & mask).view(np.float32)
    lo = ((w - hi).view(np.uint32) & mask).view(np.float32)
    return hi, lo


def test_split_tf32_weights_reconstruct_the_kernel():
    """The f32 wrappers' weight split: the kernel's masks, OHWI pairs, hi + lo within 2^-21.

    ``split_tf32(ohwi(k))`` is ``(2, Cout, 9 Cin)``: row o of each half is
    output channel o's (dy, dx, ci) weights, hi in [0] and the remainder in
    [1], each a TF32 value (low 13 mantissa bits 0).
    """
    rng = np.random.default_rng(11)
    k = (rng.standard_normal((3, 3, 12, 20)) * np.exp(rng.uniform(-20, 20, (3, 3, 12, 20))))
    k = k.astype(np.float32)
    pair = tma.split_tf32(tma.ohwi(torch.from_numpy(k)))
    assert pair.shape == (2, 20, 9 * 12) and pair.dtype == torch.float32
    hi, lo = split_tf32_numpy(k.reshape(-1, 20).T.copy())
    np.testing.assert_array_equal(pair[0].numpy(), hi)
    np.testing.assert_array_equal(pair[1].numpy(), lo)
    for half in (hi, lo):
        assert not (half.view(np.uint32) & np.uint32(0x1FFF)).any()
    w = k.reshape(-1, 20).T.astype(np.float64)
    err = np.abs(hi.astype(np.float64) + lo - w)
    assert (err <= 2.0**-21 * np.abs(w)).all()


def test_interleaved_gates_put_each_channel_where_the_kernel_reads_it():
    """The f32 rollout's conv A rows: OHWI, gate g of channel ch at (ch // 16) * 32 + g * 16 + ch % 16."""
    c = 48
    k_ru = torch.arange(9 * c * 2 * c, dtype=torch.float32).view(3, 3, c, 2 * c)  # HWIO
    got = gru_rollout_mod.ohwi_gates_interleaved(k_ru)
    want = tma.ohwi(k_ru)  # rows [read C | update C]
    assert got.shape == want.shape == (2 * c, 9 * c) and got.is_contiguous()
    for gate in (0, 1):
        for ch in range(c):
            assert torch.equal(got[(ch // 16) * 32 + gate * 16 + ch % 16], want[gate * c + ch])


def tc_add(acc, v):
    """acc + v as the tensor cores add into an f32 accumulator: rounded toward zero."""
    s = acc.astype(np.float64) + v
    r = s.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(s)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def test_3xtf32_dot_at_k6912_stays_inside_the_bar():
    """One output of conv2 of the 768-channel GBlock (K = 9 x 768) as the f32 kernels sum it.

    Emulated in numpy: both operands split into TF32 halves, each k8 step's
    three products (lo hi, hi lo, hi hi) exact in f32 and added into a
    group accumulator rounded toward zero (a truncating tensor-core add),
    each 32-deep group started from 0 and added to the running sum with
    round to nearest. 256 outputs at the main path's scales stay well inside
    the 1e-4 bar against a float64 dot; the same products summed in one
    truncating accumulator drift over ten times further (the design choice
    of ``halo_conv.cuh:run_groups_tf32``).
    """
    rng = np.random.default_rng(12)
    k, n = 9 * 768, 256
    a = np.maximum(rng.standard_normal((n, k)), 0).astype(np.float32)  # relu'd mid
    b = (rng.standard_normal((k, n)) * k**-0.5).astype(np.float32)
    want = np.einsum("nk,kn->n", a.astype(np.float64), b.astype(np.float64))
    (ah, al), (bh, bl) = split_tf32_numpy(a), split_tf32_numpy(b.T.copy())
    total = np.zeros(n, np.float32)
    one = np.zeros(n, np.float32)  # a single accumulator over the whole K
    for g0 in range(0, k, 32):
        part = np.zeros(n, np.float32)
        for s in range(g0, g0 + 32, 8):
            sl = slice(s, s + 8)
            for x, y in ((al, bh), (ah, bl), (ah, bh)):
                step = np.einsum("nk,nk->n", x[:, sl].astype(np.float64), y[:, sl])
                part = tc_add(part, step)
                one = tc_add(one, step)
        total = (total + part).astype(np.float32)
    err = np.abs(total - want).max()
    assert err <= 1e-5, err  # a tenth of the bar
    assert np.abs(one - want).max() > 10 * err


@pytest.mark.parametrize(
    "fn,n_args", [(convgru_rollout, 5), (gblock_fused, 9), (upsample_gblock_fused, 9)]
)
def test_wrappers_refuse_non_cpu_tensors_without_a_kernel(fn, n_args):
    """Only CPU tensors take the plain version; any other device needs the kernel."""
    meta = [torch.empty(1, 1, 1, 1, 3, device="meta")] * n_args
    with pytest.raises(ValueError, match="CUDA device"):
        fn(*meta, False) if fn is gblock_fused else fn(*meta)


def test_build_raises_clearly_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)  # no cached library
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library()
    assert not any(tmp_path.iterdir())
