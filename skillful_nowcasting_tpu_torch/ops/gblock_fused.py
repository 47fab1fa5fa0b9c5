"""Eval GBlock: hand-written CUDA kernel, its plain PyTorch version, and the fold.

Port of ``skillful_nowcasting_tpu/ops/pallas_gblock.py:gblock_fused`` (Pallas
kernel ``_gblock_kernel``) and ``fold_gblock_variables``. In eval mode a
GBlock is

    out = conv3(relu(a2 * conv3(relu(a1 * x + b1), k1) + b2), k2) + (conv1x1(x, ksc) | x) + b_out

with BN folded into the affines and spectral norm into the kernels. The public
function keeps the JAX layouts (NHWC activations, HWIO kernels). On a CUDA
tensor it launches the two tensor-core kernels of ``csrc/gblock_fused.cu``;
on a CPU tensor the plain version runs.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build


def fold_gblock_variables(block):
    """Fold an eval :class:`~skillful_nowcasting_tpu_torch.models.GBlock` into kernel arguments.

    Returns ``(k1, k2, ksc, a1, b1, a2, b2, b_out, use_sc_conv)``: HWIO kernels
    with spectral norm applied, BN folded to ``a * x + b``, conv1's bias folded
    into ``b2`` and conv2's (plus the shortcut conv's, when used) into ``b_out``.
    """

    def hwio(conv):
        return conv.weight.permute(2, 3, 1, 0).contiguous(), conv.bias  # SN applied by .weight

    def bn_affine(bn):
        a = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        return a, bn.bias - bn.running_mean * a

    k1, c1b = hwio(block.first_conv_3x3)
    k2, c2b = hwio(block.last_conv_3x3)
    ksc, scb = hwio(block.conv_1x1)
    a1, b1 = bn_affine(block.bn1)
    a2, b2 = bn_affine(block.bn2)
    b2 = a2 * c1b + b2  # relu(a2 * (conv1 + c1b) + b2)
    use_sc_conv = k1.shape[2] != k2.shape[3]  # Cin != Cout
    b_out = c2b + scb if use_sc_conv else c2b
    return k1, k2, ksc, a1, b1, a2, b2, b_out, use_sc_conv


def gblock_fused_reference(x, k1, k2, ksc, a1, b1, a2, b2, b_out, use_sc_conv):
    """Plain PyTorch eval GBlock; same arguments and result as :func:`gblock_fused`."""
    xn = x.permute(0, 3, 1, 2)
    col = lambda v: v.view(-1, 1, 1)  # noqa: E731
    y = torch.relu(xn * col(a1) + col(b1))
    y = F.conv2d(y, k1.permute(3, 2, 0, 1), padding=1)
    y = torch.relu(y * col(a2) + col(b2))
    y = F.conv2d(y, k2.permute(3, 2, 0, 1), padding=1)
    sc = F.conv2d(xn, ksc.permute(3, 2, 0, 1)) if use_sc_conv else xn
    return (y + sc + col(b_out)).permute(0, 2, 3, 1).contiguous()


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def gblock_fused(x, k1, k2, ksc, a1, b1, a2, b2, b_out, use_sc_conv):
    """Eval GBlock on ``x`` of shape ``(N, H, W, Cin)``; returns ``(N, H, W, Cout)``.

    ``k1`` is ``(3, 3, Cin, Cin)``, ``k2`` ``(3, 3, Cin, Cout)``, ``ksc`` the
    ``(1, 1, Cin, Cout)`` shortcut kernel (read only when ``use_sc_conv``;
    the shortcut is the identity otherwise, which needs ``Cin == Cout``),
    ``a1, b1, a2, b2`` of shape ``(Cin,)`` and ``b_out`` of shape ``(Cout,)``.
    CPU tensors take the plain version; CUDA tensors take the kernel or raise.
    """
    if x.device.type == "cpu":
        return gblock_fused_reference(x, k1, k2, ksc, a1, b1, a2, b2, b_out, use_sc_conv)
    if x.device.type != "cuda":
        raise ValueError(
            f"gblock_fused: tensors on {x.device}; expected CPU or one CUDA device"
        )
    n, h, w, cin = x.shape
    cout = k2.shape[-1]
    if not use_sc_conv and cin != cout:
        raise ValueError(
            f"gblock_fused: identity shortcut needs Cin == Cout, got {cin} and {cout}"
        )
    expected = {
        "x": (x, (n, h, w, cin)),
        "k1": (k1, (3, 3, cin, cin)),
        "k2": (k2, (3, 3, cin, cout)),
        "ksc": (ksc, (1, 1, cin, cout)),
        "a1": (a1, (cin,)),
        "b1": (b1, (cin,)),
        "a2": (a2, (cin,)),
        "b2": (b2, (cin,)),
        "b_out": (b_out, (cout,)),
    }
    for name, (tensor, shape) in expected.items():
        if tensor.device != x.device or tensor.device.type != "cuda":
            raise ValueError(
                f"gblock_fused: {name} is on {tensor.device}, expected one CUDA device"
            )
        if tensor.dtype != torch.float32:
            raise TypeError(f"gblock_fused: {name} is {tensor.dtype}; the kernel takes float32")
        if tuple(tensor.shape) != shape:
            raise ValueError(
                f"gblock_fused: {name} has shape {tuple(tensor.shape)}, expected {shape}"
            )
        if not tensor.is_contiguous():
            raise ValueError(f"gblock_fused: {name} must be contiguous")
    if n * h * w * max(cin, cout) >= 2**31:
        raise ValueError("gblock_fused: x is too large for 32-bit indexing")

    mid = torch.empty((n, h, w, cin), device=x.device, dtype=torch.float32)
    out = torch.empty((n, h, w, cout), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        _build.call(
            "gblock_conv1_f32",
            _ptr(x), _ptr(k1), _ptr(a1), _ptr(b1), _ptr(a2), _ptr(b2), _ptr(mid),
            n, h, w, cin, stream,
        )
        gblock_fused.launches += 1
        _build.call(
            "gblock_conv2_f32",
            _ptr(mid), _ptr(x), _ptr(k2), _ptr(ksc), _ptr(b_out), _ptr(out), int(use_sc_conv),
            n, h, w, cin, cout, stream,
        )
        gblock_fused.launches += 1
    return out


gblock_fused.launches = 0  # kernel launches since the last reset
