"""Eval ConvGRU rollout: hand-written CUDA kernels and their plain PyTorch version.

Port of ``skillful_nowcasting_tpu/ops/pallas_gru.py:convgru_rollout`` (Pallas
kernel ``_gru_kernel``). The public function keeps the JAX signature and
layouts (NHWC activations, HWIO kernels) so tests feed both identical arrays.
Each step computes

    r  = sigmoid(gx_r + conv3(h, k_r) + b_r)
    u  = sigmoid(gx_u + conv3(h, k_u) + b_u)
    c  = relu(gx_c + conv3(r * h, k_c) + b_c)
    h' = u * h + (1 - u) * c

and all ``T`` states are returned. The rollout is the ``torch.library``
custom op ``dgmr::convgru_rollout``, so ``torch.export`` records it as one
node. On a CUDA tensor one persistent cooperative launch of
``csrc/gru_rollout.cu`` runs every step, on ``wgmma`` fed by TMA: the f32
kernel (3xTF32, split-K, the weights streamed from L2) for float32
operands, the bf16 kernel (weight-stationary) for bfloat16 ones (see the
notes there for the designs and what bounds them); on a CPU tensor the
plain version runs. The wrapper pads the channels for TMA's 16-byte strides
and hands the kernels over in OHWI (output channels as K-major rows),
float32 ones split into TF32 halves.

bf16 follows the TPU kernel given bf16 operands: ``h`` and ``r * h`` are
f32 and are rounded to bf16 as they enter a conv, sums are f32, and each
output state is rounded to bf16 once. The bf16 kernel keeps ``h`` in f32
for the update and stores the two conv inputs already rounded (the same
bits).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from .. import _build
from .tma import aligned16, ohwi, split_tf32


def _static(gx_seq: torch.Tensor, n_steps: Optional[int]) -> tuple[int, bool]:
    t_in = gx_seq.shape[0]
    t = n_steps if n_steps is not None else t_in
    if t_in not in (1, t):
        raise ValueError(f"gx_seq has {t_in} steps; expected 1 (static) or n_steps={t}")
    return t, t_in == 1 and t > 1


def convgru_rollout_reference(
    gx_seq: torch.Tensor,
    h0: torch.Tensor,
    k_ru: torch.Tensor,
    k_c: torch.Tensor,
    bias: torch.Tensor,
    n_steps: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch rollout: an ``F.conv2d`` loop over the steps.

    Same arguments and result as :func:`convgru_rollout`. bf16 operands are
    computed as the bf16 kernel computes them, in f32 arithmetic: ``h`` and
    ``r * h`` are f32, rounded to bf16 on their way into each conv
    (``conv(h.bfloat16().float(), k.float())``), and each state is returned
    in bf16.
    """
    t, static = _static(gx_seq, n_steps)
    c = h0.shape[-1]
    work = torch.promote_types(gx_seq.dtype, torch.float32)
    if gx_seq.dtype == torch.bfloat16:
        enter = lambda v: v.bfloat16().to(work)  # noqa: E731
    else:
        enter = lambda v: v  # noqa: E731
    w_ru = k_ru.to(work).permute(3, 2, 0, 1)  # HWIO -> OIHW
    w_c = k_c.to(work).permute(3, 2, 0, 1)
    b = bias.to(work).view(-1, 1, 1)
    gx = gx_seq.to(work).permute(0, 1, 4, 2, 3)  # (T, B, 3C, H, W)
    h = h0.to(work).permute(0, 3, 1, 2)
    outs = []
    for step in range(t):
        g = gx[0 if static else step]
        gh = F.conv2d(enter(h), w_ru, padding=1)
        read = torch.sigmoid(g[:, :c] + gh[:, :c] + b[:c])
        update = torch.sigmoid(g[:, c : 2 * c] + gh[:, c:] + b[c : 2 * c])
        cand = torch.relu(g[:, 2 * c :] + F.conv2d(enter(read * h), w_c, padding=1) + b[2 * c :])
        h = update * h + (1.0 - update) * cand
        outs.append(h)
    return torch.stack(outs).permute(0, 1, 3, 4, 2).contiguous().to(gx_seq.dtype)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check(gx_seq, h0, k_ru, k_c, bias) -> None:
    """Every operand shares ``gx_seq``'s dtype: a float32 / bfloat16 mix is an error, not a cast."""
    for name, tensor in (("h0", h0), ("k_ru", k_ru), ("k_c", k_c), ("bias", bias)):
        if tensor.dtype != gx_seq.dtype:
            raise TypeError(
                f"convgru_rollout: {name} is {tensor.dtype} but gx_seq is {gx_seq.dtype}; "
                "every operand must have one dtype"
            )


def _launch(gx_seq, h0, k_ru, k_c, bias, t: int) -> torch.Tensor:
    """The kernel for ``gx_seq.dtype`` on the card; raises on what it does not take."""
    dtype = gx_seq.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"convgru_rollout: {dtype}; the kernels take float32 or bfloat16")
    b, h, w, c = h0.shape
    expected = {
        "gx_seq": (gx_seq, (gx_seq.shape[0], b, h, w, 3 * c)),
        "h0": (h0, (b, h, w, c)),
        "k_ru": (k_ru, (3, 3, c, 2 * c)),
        "k_c": (k_c, (3, 3, c, c)),
        "bias": (bias, (3 * c,)),
    }
    for name, (tensor, shape) in expected.items():
        if tensor.device != gx_seq.device:
            raise ValueError(
                f"convgru_rollout: {name} is on {tensor.device}, expected one CUDA device"
            )
        if tuple(tensor.shape) != shape:
            raise ValueError(
                f"convgru_rollout: {name} has shape {tuple(tensor.shape)}, expected {shape}"
            )
        if not tensor.is_contiguous():
            raise ValueError(f"convgru_rollout: {name} must be contiguous")
    if gx_seq.numel() >= 2**31:
        raise ValueError("convgru_rollout: gx_seq is too large for 32-bit indexing")

    if t == 0:
        return torch.empty((0, b, h, w, c), device=gx_seq.device, dtype=dtype)
    return _launch_kernel(gx_seq, h0, k_ru, k_c, bias, t)


def pad_channels(gx_seq, h0, k_ru, k_c, bias, multiple=8):
    """The rollout's operands with C zero-padded to a multiple of ``multiple``, and that C.

    TMA, which feeds the kernels, needs 16-byte strides (8 bf16 channels);
    the float32 kernel takes whole blocks of 16 channels
    (:func:`ohwi_gates_interleaved`). gx and bias are [read C | update C | candidate C] and
    ``k_ru``'s outputs [read C | update C], so each gate block pads on its
    own, as do the input channels of both kernels and ``h0``. A padded
    channel then stays exactly 0 (0.5 * 0 + 0.5 * relu(0)) and adds exact
    zeros to every sum, so the first C channels of the padded rollout are
    the rollout.
    """
    c = h0.shape[-1]
    pad = -(-c // multiple) * multiple - c
    if pad:
        gx_seq = F.pad(gx_seq.unflatten(-1, (3, c)), (0, pad)).flatten(-2)
        bias = F.pad(bias.view(3, c), (0, pad)).flatten()
        h0 = F.pad(h0, (0, pad))
        k_ru = F.pad(k_ru.unflatten(-1, (2, c)), (0, pad, 0, 0, 0, pad)).flatten(-2)
        k_c = F.pad(k_c, (0, pad, 0, pad))
    return gx_seq, h0, k_ru, k_c, bias, c + pad


def ohwi_gates_interleaved(k_ru: torch.Tensor) -> torch.Tensor:
    """:func:`~skillful_nowcasting_tpu_torch.ops.tma.ohwi` of ``k_ru`` with its output rows
    ``[read C | update C]`` reordered as blocks of 16 read then 16 update rows (one copy).

    The float32 kernel's output column of gate g (0 read, 1 update) and channel
    ch is then ``(ch // 16) * 32 + g * 16 + ch % 16`` (``gru_rollout.cu:gate_column``),
    so one thread of its epilogue holds both gates of a channel. C % 16 == 0.
    """
    c = k_ru.shape[-1] // 2
    return k_ru.reshape(-1, 2, c // 16, 16).permute(2, 1, 3, 0).reshape(2 * c, -1)


def _launch_kernel(gx_seq, h0, k_ru, k_c, bias, t: int) -> torch.Tensor:
    """The kernel for the operands' dtype on :func:`pad_channels`' operands.

    The kernels go in OHWI. float32 ones split into their TF32 halves
    (:func:`~skillful_nowcasting_tpu_torch.ops.tma.split_tf32`) for the
    3xTF32 products, ``k_ru``'s gates interleaved (:func:`ohwi_gates_interleaved`,
    so C pads to a multiple of 16). Scratch: float32 ``r * h`` and ``u`` and
    the split-K partial sums; bf16 ``h`` in float32 for all steps, ``u`` and
    a bf16 ``r * h``.
    """
    f32 = gx_seq.dtype == torch.float32
    b, h, w, c = h0.shape
    gx_seq, h0, k_ru, k_c, bias, cp = pad_channels(
        gx_seq, h0, k_ru, k_c, bias, multiple=16 if f32 else 8
    )
    if f32:
        k_ru_t, k_c_t = split_tf32(ohwi_gates_interleaved(k_ru)), split_tf32(ohwi(k_c))
    else:
        k_ru_t, k_c_t = ohwi(k_ru), ohwi(k_c)
    gx_seq, h0, bias = aligned16(gx_seq), aligned16(h0), aligned16(bias)
    dev = gx_seq.device
    out = torch.empty((t, b, h, w, cp), device=dev, dtype=gx_seq.dtype)
    state = torch.empty((b, h, w, cp), device=dev, dtype=torch.float32)
    u = torch.empty_like(state)
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        if f32:
            floats = ctypes.c_longlong()
            _build.call("gru_rollout_workspace_f32", b, h, w, cp, ctypes.byref(floats))
            part = torch.empty(floats.value, device=dev, dtype=torch.float32)
            _build.call(
                "gru_rollout_f32",
                _ptr(gx_seq), _ptr(h0), _ptr(k_ru_t), _ptr(k_c_t), _ptr(bias), _ptr(out),
                _ptr(state), _ptr(u), _ptr(part),  # state: r * h
                b, h, w, cp, t, gx_seq.shape[0], stream,
            )
            convgru_rollout.launches += 1
        else:
            rh = torch.empty((b, h, w, cp), device=dev, dtype=torch.bfloat16)
            _build.call(
                "gru_rollout_bf16",
                _ptr(gx_seq), _ptr(h0), _ptr(k_ru_t), _ptr(k_c_t), _ptr(bias), _ptr(out),
                _ptr(state), _ptr(rh), _ptr(u),  # state: h in f32 for all steps
                b, h, w, cp, t, gx_seq.shape[0], stream,
            )
            convgru_rollout.launches_bf16 += 1
    return out if cp == c else out[..., :c].contiguous()


@torch.library.custom_op("dgmr::convgru_rollout", mutates_args=())
def _rollout_op(
    gx_seq: torch.Tensor,
    h0: torch.Tensor,
    k_ru: torch.Tensor,
    k_c: torch.Tensor,
    bias: torch.Tensor,
    n_steps: int,
) -> torch.Tensor:
    _check(gx_seq, h0, k_ru, k_c, bias)
    if gx_seq.device.type == "cpu":
        return convgru_rollout_reference(gx_seq, h0, k_ru, k_c, bias, n_steps)
    return _launch(gx_seq, h0, k_ru, k_c, bias, n_steps)


@_rollout_op.register_fake
def _(gx_seq, h0, k_ru, k_c, bias, n_steps):
    b, h, w, c = h0.shape
    return gx_seq.new_empty((n_steps, b, h, w, c))


def convgru_rollout(
    gx_seq: torch.Tensor,
    h0: torch.Tensor,
    k_ru: torch.Tensor,
    k_c: torch.Tensor,
    bias: torch.Tensor,
    n_steps: Optional[int] = None,
) -> torch.Tensor:
    """Run the eval ConvGRU recurrence (the custom op ``dgmr::convgru_rollout``).

    Args:
        gx_seq: ``(T, B, H, W, 3C)`` input-part gate pre-activations (read,
            update, candidate), spectral norm applied. A leading 1 with
            ``n_steps > 1`` is the static input of the Sampler's bottom level,
            reused every step.
        h0: ``(B, H, W, C)`` initial hidden state.
        k_ru: ``(3, 3, C, 2C)`` fused read+update hidden kernels.
        k_c: ``(3, 3, C, C)`` candidate hidden kernel.
        bias: ``(3C,)`` gate biases (read, update, candidate).
        n_steps: number of steps (default ``gx_seq.shape[0]``).

    Returns:
        ``(T, B, H, W, C)`` hidden states in the operands' dtype (one dtype
        for all, float32 or bfloat16 on the card). CPU tensors take the
        plain version; CUDA tensors take the kernel for their dtype or raise.
    """
    t, _ = _static(gx_seq, n_steps)
    if gx_seq.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"convgru_rollout: tensors on {gx_seq.device}; expected CPU or one CUDA device"
        )
    return torch.ops.dgmr.convgru_rollout(gx_seq, h0, k_ru, k_c, bias, t)


convgru_rollout.launches = 0  # f32 kernel launches since the last reset
convgru_rollout.launches_bf16 = 0  # bf16 kernel launches since the last reset
