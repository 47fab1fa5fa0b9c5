"""Eval ConvGRU rollout: hand-written CUDA kernel and its plain PyTorch version.

Port of ``skillful_nowcasting_tpu/ops/pallas_gru.py:convgru_rollout`` (Pallas
kernel ``_gru_kernel``). The public function keeps the JAX signature and
layouts (NHWC activations, HWIO kernels) so tests feed both identical arrays.
Each step computes

    r  = sigmoid(gx_r + conv3(h, k_r) + b_r)
    u  = sigmoid(gx_u + conv3(h, k_u) + b_u)
    c  = relu(gx_c + conv3(r * h, k_c) + b_c)
    h' = u * h + (1 - u) * c

and all ``T`` states are returned. On a CUDA tensor one persistent
cooperative launch of ``csrc/gru_rollout.cu`` runs every step (see the note
there for the design and what bounds it); on a CPU tensor the plain version
runs.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from .. import _build


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

    Same arguments and result as :func:`convgru_rollout`.
    """
    t, static = _static(gx_seq, n_steps)
    c = h0.shape[-1]
    w_ru = k_ru.permute(3, 2, 0, 1)  # HWIO -> OIHW
    w_c = k_c.permute(3, 2, 0, 1)
    b = bias.view(-1, 1, 1)
    gx = gx_seq.permute(0, 1, 4, 2, 3)  # (T, B, 3C, H, W)
    h = h0.permute(0, 3, 1, 2)
    outs = []
    for step in range(t):
        g = gx[0 if static else step]
        gh = F.conv2d(h, w_ru, padding=1)
        read = torch.sigmoid(g[:, :c] + gh[:, :c] + b[:c])
        update = torch.sigmoid(g[:, c : 2 * c] + gh[:, c:] + b[c : 2 * c])
        cand = torch.relu(g[:, 2 * c :] + F.conv2d(read * h, w_c, padding=1) + b[2 * c :])
        h = update * h + (1.0 - update) * cand
        outs.append(h)
    return torch.stack(outs).permute(0, 1, 3, 4, 2).contiguous()


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def convgru_rollout(
    gx_seq: torch.Tensor,
    h0: torch.Tensor,
    k_ru: torch.Tensor,
    k_c: torch.Tensor,
    bias: torch.Tensor,
    n_steps: Optional[int] = None,
) -> torch.Tensor:
    """Run the eval ConvGRU recurrence.

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
        ``(T, B, H, W, C)`` hidden states. CPU tensors take the plain version;
        CUDA tensors take the kernel or raise.
    """
    if gx_seq.device.type == "cpu":
        return convgru_rollout_reference(gx_seq, h0, k_ru, k_c, bias, n_steps)
    if gx_seq.device.type != "cuda":
        raise ValueError(
            f"convgru_rollout: tensors on {gx_seq.device}; expected CPU or one CUDA device"
        )
    t, static = _static(gx_seq, n_steps)
    b, h, w, c = h0.shape
    expected = {
        "gx_seq": (gx_seq, (gx_seq.shape[0], b, h, w, 3 * c)),
        "h0": (h0, (b, h, w, c)),
        "k_ru": (k_ru, (3, 3, c, 2 * c)),
        "k_c": (k_c, (3, 3, c, c)),
        "bias": (bias, (3 * c,)),
    }
    for name, (tensor, shape) in expected.items():
        if tensor.device != gx_seq.device or tensor.device.type != "cuda":
            raise ValueError(
                f"convgru_rollout: {name} is on {tensor.device}, expected one CUDA device"
            )
        if tensor.dtype != torch.float32:
            raise TypeError(f"convgru_rollout: {name} is {tensor.dtype}; the kernel takes float32")
        if tuple(tensor.shape) != shape:
            raise ValueError(
                f"convgru_rollout: {name} has shape {tuple(tensor.shape)}, expected {shape}"
            )
        if not tensor.is_contiguous():
            raise ValueError(f"convgru_rollout: {name} must be contiguous")
    if gx_seq.numel() >= 2**31:
        raise ValueError("convgru_rollout: gx_seq is too large for 32-bit indexing")

    out = torch.empty((t, b, h, w, c), device=gx_seq.device, dtype=torch.float32)
    if t == 0:
        return out
    with torch.cuda.device(gx_seq.device):
        floats = ctypes.c_longlong()
        _build.call("gru_rollout_workspace_f32", b, h, w, c, ctypes.byref(floats))
        rh = torch.empty((b, h, w, c), device=gx_seq.device, dtype=torch.float32)
        u = torch.empty_like(rh)
        part = torch.empty(floats.value, device=gx_seq.device, dtype=torch.float32)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        _build.call(
            "gru_rollout_f32",
            _ptr(gx_seq), _ptr(h0), _ptr(k_ru), _ptr(k_c), _ptr(bias), _ptr(out),
            _ptr(rh), _ptr(u), _ptr(part),
            b, h, w, c, t, gx_seq.shape[0], stream,
        )
        convgru_rollout.launches += 1
    return out


convgru_rollout.launches = 0  # kernel launches since the last reset
