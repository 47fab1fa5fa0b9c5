"""Attention einsums: reference-bug-compatible and corrected variants.

Port of ``skillful_nowcasting_tpu/ops/attention.py`` on NCHW inputs.
``attention_torch_compat`` reproduces quirk Q1 of the reference: tokens are
(channel, row) pairs and the width axis is the feature dimension,

    beta[c, h, L] = softmax_L(sum_w q[c, h, w] * kflat[L, w]),  L = c' * H + h'
    out[c, h, w]  = sum_L beta[c, h, L] * vflat[L, w]

which the pretrained weights were trained with. ``attention_fixed`` is the
intended spatial attention over (h, w) tokens with channel features.
"""

from __future__ import annotations

import torch


def attention_torch_compat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bug-compatible attention on ``(B, C, H, W)`` inputs; returns ``(B, Cq, H, W)``."""
    b, cq, h, w = q.shape
    kf = k.reshape(b, cq * h, w)
    vf = v.reshape(b, v.shape[1] * h, w)
    beta = torch.softmax(torch.einsum("bchw,blw->bchl", q, kf), dim=-1)
    return torch.einsum("bchl,blw->bchw", beta, vf)


def attention_fixed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Spatial attention on ``(B, C, H, W)``: tokens (h, w), features channels."""
    b, _, h, w = q.shape
    qf = q.flatten(2).transpose(1, 2)  # (B, HW, Cq)
    kf = k.flatten(2).transpose(1, 2)
    vf = v.flatten(2).transpose(1, 2)
    beta = torch.softmax(qf @ kf.transpose(1, 2), dim=-1)
    return (beta @ vf).transpose(1, 2).reshape(b, v.shape[1], h, w)
