"""The eval UpsampleGBlock on ``dgmr::upsample_gblock_fused``, on the CPU (torch only, no JAX).

In eval, nearest upsampling commutes with the folded BatchNorm affines, the
ReLU and the 1x1 shortcut, so an UpsampleGBlock is a GBlock with the 1x1
shortcut on the upsampled input. Held here: the op's plain version is
exactly that; the block's eval route through the op equals its layers run
eagerly in float64 to 1e-12 of the largest output (equal widths, where the
shortcut is forced, and odd channel counts), in the layout the layers give;
train mode keeps the layers; the kernels' gather from a low-resolution halo
box (``csrc/halo_conv.cuh:load_a_up`` with the affine of
``csrc/gblock_fused.cu:affine_box_f32``), mirrored in torch, reads the
upsampled input's zero-padded halo; and the variant's kernels carry names
that no benchmark reader of the other kernels takes. The kernels themselves
are held against the plain version on the card (``tests/test_torch_cuda.py``).
"""

import re
from pathlib import Path

import pytest
import torch

from portbench.metrics import conv_ms
from skillful_nowcasting_tpu_torch import profiling
from skillful_nowcasting_tpu_torch.models import UpsampleGBlock
from skillful_nowcasting_tpu_torch.models import common as common_mod
from skillful_nowcasting_tpu_torch.ops import (
    fold_gblock_variables,
    gblock_fused_reference,
    upsample_gblock_fused,
    upsample_gblock_fused_reference,
    upsample_nearest_2x,
)

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parent.parent / "skillful_nowcasting_tpu_torch" / "csrc"
WIDTHS = [(8, 4), (6, 6), (5, 3), (7, 7)]  # (Cin, Cout): halving, equal, odd


def block(cin, cout, seed=0):
    """A float64 eval UpsampleGBlock with BatchNorm statistics and biases away from their init."""
    torch.manual_seed(seed)
    b = UpsampleGBlock(cin, cout)
    with torch.no_grad():
        for bn in (b.bn1, b.bn2):
            bn.running_mean.normal_()
            bn.running_var.uniform_(0.5, 2.0)
            bn.weight.normal_()
            bn.bias.normal_()
        for conv in (b.conv_1x1, b.first_conv_3x3, b.last_conv_3x3):
            conv.bias.normal_()
    return b.double().eval()


def layers(b, x):
    """The block's layers run eagerly: train mode's code, here on the running statistics."""
    sc = b.conv_1x1(upsample_nearest_2x(x))
    y = upsample_nearest_2x(torch.relu(b.bn1(x)))
    y = torch.relu(b.bn2(b.first_conv_3x3(y)))
    return b.last_conv_3x3(y) + sc


def op_args(b, dtype=torch.float64):
    *folded, use_sc_conv = fold_gblock_variables(b, dtype, shortcut=True)
    assert use_sc_conv is True
    return folded


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
def test_plain_version_is_the_gblock_on_the_upsampled_input(dtype):
    b = block(6, 4)
    x = torch.randn((2, 5, 7, 6), generator=torch.Generator().manual_seed(1)).to(dtype)
    args = op_args(b.float() if dtype != torch.float64 else b, dtype)
    up = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    want = gblock_fused_reference(up, *args, True)
    got = upsample_gblock_fused_reference(x, *args)
    assert got.shape == (2, 10, 14, 4) and got.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(upsample_gblock_fused(x, *args), want)  # the custom op on the CPU


@pytest.mark.parametrize("cin,cout", WIDTHS)
@pytest.mark.parametrize("channels_last", [False, True])
def test_eval_route_equals_the_layers(cin, cout, channels_last):
    b = block(cin, cout)
    x = torch.randn((3, 5, 7, cin), generator=torch.Generator().manual_seed(2), dtype=torch.float64)
    x = x.permute(0, 3, 1, 2)  # NHWC memory, as the GBlock before it leaves it
    if not channels_last:
        x = x.contiguous()
    with torch.no_grad(), profiling.record() as log:
        got = b(x)
    names = [s["name"] for s in log.spans()]
    assert names == ["dgmr.upsample_gblock", "dgmr.derive.upsample_gblock"] + ["dgmr.derive.sn"] * 3
    with torch.no_grad():
        want = layers(b, x)
    assert got.shape == want.shape == (3, cout, 10, 14)
    assert (got - want).abs().max().item() <= 1e-12 * want.abs().max().item()
    if channels_last:  # the layout the layers give a channels-last input
        assert got.stride() == want.stride()


def test_fold_forces_the_shortcut_at_equal_widths():
    b = block(6, 6)
    k1, k2, ksc, a1, b1, a2, b2, b_out, use_sc_conv = fold_gblock_variables(b)
    assert use_sc_conv is False and torch.equal(b_out, b.last_conv_3x3.bias)
    *_, b_forced, forced = fold_gblock_variables(b, shortcut=True)
    assert forced is True
    assert torch.equal(b_forced, b.last_conv_3x3.bias + b.conv_1x1.bias)


def test_train_mode_keeps_the_layers(monkeypatch):
    def refuse(*args):
        raise AssertionError("train mode reached the fused op")

    monkeypatch.setattr(common_mod, "upsample_gblock_fused", refuse)
    b = block(6, 6).train()
    x = torch.randn((2, 6, 4, 4), generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    mean = b.bn1.running_mean.clone()
    assert b(x).shape == (2, 6, 8, 8)
    assert not torch.equal(b.bn1.running_mean, mean)  # batch statistics, as before


def mirrored_operand(x, a, s, y0, x0):
    """conv1's A operand of the output patch at (y0, x0), as the upsampling kernels build it.

    The 6x6 low-resolution box at (y0 / 2 - 1, x0 / 2 - 1) of ``x`` (N=1, H,
    W, C), zero outside the image as TMA fills it, the affine applied to its
    in-image pixels only; then for each of the patch's 64 rows and 9 taps the
    box pixel ``load_a_up`` gathers. Returns (64, 9, C).
    """
    _, h, w, c = x.shape
    side = 6
    box = torch.zeros((side, side, c), dtype=x.dtype)
    for by in range(side):
        for bx in range(side):
            yy, xx = y0 // 2 - 1 + by, x0 // 2 - 1 + bx
            if 0 <= yy < h and 0 <= xx < w:
                box[by, bx] = torch.relu(a * x[0, yy, xx] + s)
    flat = box.reshape(side * side, c)
    out = torch.empty((64, 9, c), dtype=x.dtype)
    for r in range(64):
        py, px = r >> 3, r & 7
        for tap in range(9):
            q = ((py + tap // 3 + 1) >> 1) * side + ((px + tap % 3 + 1) >> 1)
            out[r, tap] = flat[q]
    return out


def test_low_res_gather_reads_the_upsampled_halo():
    """Every patch of a 10x14 output (patches over its edges too): the gather is the halo of
    relu(a * upsample(x) + s), zero outside the image (SAME padding after the affine)."""
    h, w, c = 5, 7, 3
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((1, h, w, c), generator=gen, dtype=torch.float64)
    a, s = torch.randn(c, generator=gen, dtype=torch.float64), torch.randn(c, generator=gen,
                                                                           dtype=torch.float64)
    up = torch.relu(a * x.repeat_interleave(2, 1).repeat_interleave(2, 2) + s)[0]
    padded = torch.zeros((2 * h + 10, 2 * w + 10, c), dtype=x.dtype)
    padded[1:2 * h + 1, 1:2 * w + 1] = up  # halo pixel (fy, fx) of output (y, x) at y + fy
    for y0 in range(0, 2 * h, 8):
        for x0 in range(0, 2 * w, 8):
            got = mirrored_operand(x, a, s, y0, x0)
            for r in range(64):
                py, px = r >> 3, r & 7
                for tap in range(9):
                    want = padded[y0 + py + tap // 3, x0 + px + tap % 3]
                    assert torch.equal(got[r, tap], want), (y0, x0, r, tap)


def test_variant_kernel_names_stay_out_of_the_other_readers():
    """``gblock_roofline`` reads kernels named ``gblock_conv``; ``conv_ms`` the library's."""
    source = (CSRC / "gblock_fused.cu").read_text()
    kernels = re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s+(\w+)\(", source)
    up = {"upsample_gblock_a_f32_kernel", "upsample_gblock_b_f32_kernel",
          "upsample_gblock_a_bf16_kernel", "upsample_gblock_b_bf16_kernel"}
    gblock = {"gblock_conv1_kernel", "gblock_conv2_kernel", "gblock_conv1_bf16_kernel",
              "gblock_conv2_bf16_kernel"}
    assert set(kernels) == up | gblock
    for name in up:
        assert "gblock_conv" not in name
        for args in ("CUtensorMap, CUtensorMap", "CUtensorMap, CUtensorMap, CUtensorMap, "
                     "CUtensorMap"):
            for t in ("float", "unsigned short"):
                traced = f"void dgmr::{name}<128>({args}, dgmr::GBlockArgs<{t}>)"
                assert not conv_ms.is_library(traced), traced
