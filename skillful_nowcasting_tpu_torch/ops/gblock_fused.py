"""Eval GBlock: hand-written CUDA kernels, their plain PyTorch version, and the fold.

Port of ``skillful_nowcasting_tpu/ops/pallas_gblock.py:gblock_fused`` (Pallas
kernel ``_gblock_kernel``) and ``fold_gblock_variables``. In eval mode a
GBlock is

    out = conv3(relu(a2 * conv3(relu(a1 * x + b1), k1) + b2), k2) + (conv1x1(x, ksc) | x) + b_out

with BN folded into the affines and spectral norm into the kernels. The public
function keeps the JAX layouts (NHWC activations, HWIO kernels) and is the
``torch.library`` custom op ``dgmr::gblock_fused``, so ``torch.export``
records it as one node. On a CUDA tensor it launches the two tensor-core
kernels of ``csrc/gblock_fused.cu`` for its dtype (``wgmma`` fed by TMA:
3xTF32 for float32, bf16 for bfloat16); on a CPU tensor the plain version
runs. Both wrappers pad the channels for TMA's 16-byte strides and hand the
weights over in OHWI (output channels as K-major rows); the float32 one
also splits them into TF32 halves.

bf16 follows the TPU kernel given bf16 operands: ``x`` and the kernels are
bf16, the affines f32; ``relu(a1 * x + b1)`` and ``mid`` are computed in f32
and rounded to bf16 as they enter a conv; sums are f32 and the output is
rounded to bf16 once. The bf16 kernels store ``mid`` already rounded (the
same bits).

An eval UpsampleGBlock is the same block on ``x`` upsampled 2x (nearest)
with the 1x1 shortcut always applied: the upsample commutes with every
per-pixel step (the affines, the ReLU, the 1x1 conv). The custom op
``dgmr::upsample_gblock_fused`` runs it on the kernels' upsampling variant,
which reads ``x`` at half resolution and upsamples inside its loads.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build
from ..profiling import span
from .resize import upsample_nearest_2x
from .tma import aligned16, ohwi, split_tf32


def fold_gblock_variables(block, dtype=None, shortcut=False):
    """Fold an eval :class:`~skillful_nowcasting_tpu_torch.models.GBlock` into kernel arguments.

    Returns ``(k1, k2, ksc, a1, b1, a2, b2, b_out, use_sc_conv)``: HWIO kernels
    with spectral norm applied, BN folded to ``a * x + b``, conv1's bias folded
    into ``b2`` and conv2's (plus the shortcut conv's, when used) into ``b_out``.
    Everything is computed in the parameters' dtype; the kernels are then cast
    to ``dtype`` (the activation's, e.g. bfloat16), the affines to float32
    where ``dtype`` is float32 or bfloat16 (a float64 model serving float32).
    The 1x1 shortcut is used where Cin != Cout, and always with
    ``shortcut=True``: an UpsampleGBlock applies it whatever its widths.
    """

    def hwio(conv):  # SN applied by .weight
        k = conv.weight.permute(2, 3, 1, 0)
        return (k if dtype is None else k.to(dtype)).contiguous(), conv.bias

    def bn_affine(bn):
        a = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        return a, bn.bias - bn.running_mean * a

    k1, c1b = hwio(block.first_conv_3x3)
    k2, c2b = hwio(block.last_conv_3x3)
    ksc, scb = hwio(block.conv_1x1)
    a1, b1 = bn_affine(block.bn1)
    a2, b2 = bn_affine(block.bn2)
    b2 = a2 * c1b + b2  # relu(a2 * (conv1 + c1b) + b2)
    use_sc_conv = shortcut or k1.shape[2] != k2.shape[3]  # Cin != Cout
    b_out = c2b + scb if use_sc_conv else c2b
    if dtype is not None:
        affine = torch.promote_types(dtype, torch.float32)
        a1, b1, a2, b2, b_out = (t.to(affine) for t in (a1, b1, a2, b2, b_out))
    return k1, k2, ksc, a1, b1, a2, b2, b_out, use_sc_conv


def gblock_fused_reference(x, k1, k2, ksc, a1, b1, a2, b2, b_out, use_sc_conv):
    """Plain PyTorch eval GBlock; same arguments and result as :func:`gblock_fused`.

    bf16 operands are computed as the bf16 kernels compute them, in f32
    arithmetic: ``relu(a1 * x + b1)`` and ``mid`` are f32, rounded to bf16
    on their way into each conv; the output is rounded to bf16 once.
    """
    work = a1.dtype
    if x.dtype == torch.bfloat16:
        enter = lambda v: v.bfloat16().to(work)  # noqa: E731
    else:
        enter = lambda v: v  # noqa: E731
    xn = x.permute(0, 3, 1, 2).to(work)
    col = lambda v: v.view(-1, 1, 1)  # noqa: E731
    oihw = lambda k: k.to(work).permute(3, 2, 0, 1)  # noqa: E731
    y = torch.relu(xn * col(a1) + col(b1))
    y = F.conv2d(enter(y), oihw(k1), padding=1)
    y = torch.relu(y * col(a2) + col(b2))
    y = F.conv2d(enter(y), oihw(k2), padding=1)
    sc = F.conv2d(xn, oihw(ksc)) if use_sc_conv else xn
    return (y + sc + col(b_out)).permute(0, 2, 3, 1).contiguous().to(x.dtype)


def upsample_gblock_fused_reference(x, k1, k2, ksc, a1, b1, a2, b2, b_out):
    """Plain PyTorch eval UpsampleGBlock: :func:`upsample_gblock_fused`'s arguments and result.

    :func:`gblock_fused_reference` with the 1x1 shortcut on ``x`` upsampled
    2x (nearest), which is exact in any dtype.
    """
    up = upsample_nearest_2x(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return gblock_fused_reference(up, k1, k2, ksc, a1, b1, a2, b2, b_out, True)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check(x, k1, k2, ksc, a1, b1, a2, b2, b_out, op="gblock_fused") -> None:
    """x and the kernels share one dtype; the affines are float32 (float64 for a float64 x)."""
    affine = torch.promote_types(x.dtype, torch.float32)
    want = {"k1": (k1, x.dtype), "k2": (k2, x.dtype), "ksc": (ksc, x.dtype), "a1": (a1, affine),
            "b1": (b1, affine), "a2": (a2, affine), "b2": (b2, affine), "b_out": (b_out, affine)}
    for name, (tensor, dtype) in want.items():
        if tensor.dtype != dtype:
            raise TypeError(
                f"{op}: {name} is {tensor.dtype}, expected {dtype} for x of {x.dtype} "
                "(x and the kernels share one dtype; the affines are float32)"
            )


def _launch(x, k1, k2, ksc, a1, b1, a2, b2, b_out, use_sc_conv, up=False) -> torch.Tensor:
    """The two kernels for ``x.dtype`` on the card (``up``: the upsampling variant's); raises
    on what they do not take."""
    op = "upsample_gblock_fused" if up else "gblock_fused"
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{op}: {x.dtype}; the kernels take float32 or bfloat16")
    n, h, w, cin = x.shape
    cout = k2.shape[-1]
    if not use_sc_conv and cin != cout:
        raise ValueError(
            f"{op}: identity shortcut needs Cin == Cout, got {cin} and {cout}"
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
        if tensor.device != x.device:
            raise ValueError(f"{op}: {name} is on {tensor.device}, expected one CUDA device")
        if tuple(tensor.shape) != shape:
            raise ValueError(f"{op}: {name} has shape {tuple(tensor.shape)}, expected {shape}")
        if not tensor.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
    if n * h * w * max(cin, cout) * (4 if up else 1) >= 2**31:
        raise ValueError(f"{op}: the output is too large for 32-bit indexing")

    return _launch_kernels(x, k1, k2, ksc, a1, b1, a2, b2, b_out, use_sc_conv, up)


def pad_channels(x, k1, k2, ksc, a1, b1, a2, b2, b_out, multiple=8):
    """The GBlock's operands with Cin and Cout zero-padded to multiples of ``multiple``.

    TMA, which feeds the kernels, needs 16-byte strides: 8 bf16 or 4 float32
    channels. Zero weights and zero ``a1``/``b1`` make every padded channel
    of ``mid`` and of the output exactly 0 and add exact zeros to every sum,
    so the first Cout channels of the padded block are the block.
    """
    cin, cout = x.shape[-1], k2.shape[-1]
    pi, po = -(-cin // multiple) * multiple - cin, -(-cout // multiple) * multiple - cout
    if pi or po:
        x = F.pad(x, (0, pi))
        k1 = F.pad(k1, (0, pi, 0, pi))
        k2 = F.pad(k2, (0, po, 0, pi))
        ksc = F.pad(ksc, (0, po, 0, pi))
        a1, b1, a2, b2 = (F.pad(v, (0, pi)) for v in (a1, b1, a2, b2))
        b_out = F.pad(b_out, (0, po))
    return x, k1, k2, ksc, a1, b1, a2, b2, b_out


def _launch_kernels(x, k1, k2, ksc, a1, b1, a2, b2, b_out, use_sc_conv, up=False) -> torch.Tensor:
    """The two kernels for ``x.dtype`` (wgmma + TMA) on :func:`pad_channels`' operands.

    The kernels go in OHWI; float32 ones split once a call into their TF32
    halves (:func:`~skillful_nowcasting_tpu_torch.ops.tma.split_tf32`) for
    the 3xTF32 products. ``mid`` has ``x``'s dtype: the bf16 conv1 stores it
    as conv2 would round it on entry. ``up``: the upsampling variant, whose
    ``mid`` and output are at twice ``x``'s resolution.
    """
    f32 = x.dtype == torch.float32
    prep = (lambda k: split_tf32(ohwi(k))) if f32 else ohwi  # noqa: E731
    suffix = "f32" if f32 else "bf16"
    cout = k2.shape[-1]
    with span(f"dgmr.derive.{'upsample_gblock' if up else 'gblock'}_layout", device=x):
        x, k1, k2, ksc, a1, b1, a2, b2, b_out = pad_channels(
            x, k1, k2, ksc, a1, b1, a2, b2, b_out, multiple=4 if f32 else 8
        )
        k1t, k2t = prep(k1), prep(k2)
        ksct = prep(ksc) if use_sc_conv else k2t  # not read with the identity shortcut
    n, h, w, ci = x.shape
    co = k2.shape[-1]
    oh, ow = (2 * h, 2 * w) if up else (h, w)
    x = aligned16(x)
    mid = torch.empty((n, oh, ow, ci), device=x.device, dtype=x.dtype)
    out = torch.empty((n, oh, ow, co), device=x.device, dtype=x.dtype)
    # The upsampling variant's entry points take no flag: their shortcut is the 1x1 conv.
    conv1, conv2, flag = (("upsample_gblock_a", "upsample_gblock_b", ()) if up else
                          ("gblock_conv1", "gblock_conv2", (int(use_sc_conv),)))
    counted = upsample_gblock_fused if up else gblock_fused
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        _build.call(
            f"{conv1}_{suffix}",
            _ptr(x), _ptr(k1t), _ptr(a1), _ptr(b1), _ptr(a2), _ptr(b2), _ptr(mid),
            n, h, w, ci, stream,
        )
        _count(counted, x.dtype)
        _build.call(
            f"{conv2}_{suffix}",
            _ptr(mid), _ptr(x), _ptr(k2t), _ptr(ksct), _ptr(b_out), _ptr(out),
            *flag, n, h, w, ci, co, stream,
        )
        _count(counted, x.dtype)
    return out if co == cout else out[..., :cout].contiguous()


def _count(fn, dtype) -> None:
    if dtype == torch.float32:
        fn.launches += 1
    else:
        fn.launches_bf16 += 1


@torch.library.custom_op("dgmr::gblock_fused", mutates_args=())
def _gblock_op(
    x: torch.Tensor,
    k1: torch.Tensor,
    k2: torch.Tensor,
    ksc: torch.Tensor,
    a1: torch.Tensor,
    b1: torch.Tensor,
    a2: torch.Tensor,
    b2: torch.Tensor,
    b_out: torch.Tensor,
    use_sc_conv: bool,
) -> torch.Tensor:
    _check(x, k1, k2, ksc, a1, b1, a2, b2, b_out)
    if x.device.type == "cpu":
        return gblock_fused_reference(x, k1, k2, ksc, a1, b1, a2, b2, b_out, use_sc_conv)
    return _launch(x, k1, k2, ksc, a1, b1, a2, b2, b_out, use_sc_conv)


@_gblock_op.register_fake
def _(x, k1, k2, ksc, a1, b1, a2, b2, b_out, use_sc_conv):
    n, h, w, _ = x.shape
    return x.new_empty((n, h, w, k2.shape[-1]))


def gblock_fused(x, k1, k2, ksc, a1, b1, a2, b2, b_out, use_sc_conv):
    """Eval GBlock on ``x`` of shape ``(N, H, W, Cin)``; returns ``(N, H, W, Cout)``.

    The custom op ``dgmr::gblock_fused``. ``k1`` is ``(3, 3, Cin, Cin)``,
    ``k2`` ``(3, 3, Cin, Cout)``, ``ksc`` the ``(1, 1, Cin, Cout)`` shortcut
    kernel (read only when ``use_sc_conv``; the shortcut is the identity
    otherwise, which needs ``Cin == Cout``), all in ``x``'s dtype (float32 or
    bfloat16 on the card); ``a1, b1, a2, b2`` of shape ``(Cin,)`` and
    ``b_out`` of shape ``(Cout,)`` in float32. The result has ``x``'s dtype.
    CPU tensors take the plain version; CUDA tensors take the kernels for
    their dtype or raise.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gblock_fused: tensors on {x.device}; expected CPU or one CUDA device")
    return torch.ops.dgmr.gblock_fused(x, k1, k2, ksc, a1, b1, a2, b2, b_out, bool(use_sc_conv))


gblock_fused.launches = 0  # f32 kernel launches since the last reset (two per call)
gblock_fused.launches_bf16 = 0  # bf16 kernel launches since the last reset (two per call)


@torch.library.custom_op("dgmr::upsample_gblock_fused", mutates_args=())
def _upsample_gblock_op(
    x: torch.Tensor,
    k1: torch.Tensor,
    k2: torch.Tensor,
    ksc: torch.Tensor,
    a1: torch.Tensor,
    b1: torch.Tensor,
    a2: torch.Tensor,
    b2: torch.Tensor,
    b_out: torch.Tensor,
) -> torch.Tensor:
    _check(x, k1, k2, ksc, a1, b1, a2, b2, b_out, op="upsample_gblock_fused")
    if x.device.type == "cpu":
        return upsample_gblock_fused_reference(x, k1, k2, ksc, a1, b1, a2, b2, b_out)
    return _launch(x, k1, k2, ksc, a1, b1, a2, b2, b_out, True, up=True)


@_upsample_gblock_op.register_fake
def _(x, k1, k2, ksc, a1, b1, a2, b2, b_out):
    n, h, w, _ = x.shape
    return x.new_empty((n, 2 * h, 2 * w, k2.shape[-1]))


def upsample_gblock_fused(x, k1, k2, ksc, a1, b1, a2, b2, b_out):
    """Eval UpsampleGBlock on ``x`` of shape ``(N, H, W, Cin)``; returns ``(N, 2H, 2W, Cout)``.

    The custom op ``dgmr::upsample_gblock_fused``: :func:`gblock_fused` on
    ``x`` upsampled 2x (nearest) with the 1x1 shortcut ``ksc`` always
    applied, the arguments as there (``fold_gblock_variables(block,
    shortcut=True)``'s, without the flag). On the card the kernels read
    ``x`` at its own resolution and upsample inside their loads.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"upsample_gblock_fused: tensors on {x.device}; expected CPU or one CUDA device"
        )
    return torch.ops.dgmr.upsample_gblock_fused(x, k1, k2, ksc, a1, b1, a2, b2, b_out)


upsample_gblock_fused.launches = 0  # f32 kernel launches since the last reset (two per call)
upsample_gblock_fused.launches_bf16 = 0  # bf16 kernel launches since the last reset (two per call)
