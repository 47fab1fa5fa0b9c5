"""Operand layouts the kernels' TMA loads and ``wgmma`` need (``csrc/hopper.cuh``).

TMA reads from addresses and strides that are multiples of 16 bytes,
``wgmma`` takes the weights as K-major rows, and the f32 kernels' 3xTF32
products take the weights already split into TF32 halves: the kernels'
wrappers prepare their operands with these.
"""

from __future__ import annotations

import torch


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data does not start on 16 bytes."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ohwi(k: torch.Tensor) -> torch.Tensor:
    """An HWIO kernel in OHWI memory order: the transpose of its (KH KW Cin, Cout) matrix.

    Each output channel becomes one K-major row of 9 Cin (or Cin) values.
    """
    return k.reshape(-1, k.shape[-1]).t().contiguous()


TF32_MASK = -8192  # 0xffffe000 as int32: sign, exponent and the 10 mantissa bits of TF32


def split_tf32(w: torch.Tensor) -> torch.Tensor:
    """A contiguous float32 ``w`` as ``(2, *w.shape)``: its TF32 high part and remainder.

    The bit masks of ``csrc/hopper.cuh:split_tf32``: ``hi`` is ``w`` with
    its low 13 mantissa bits cleared, ``w - hi`` is exact in float32, and
    ``lo`` is that remainder cleared the same way, so ``hi + lo`` is ``w``
    to within 2^-21 of ``|w|``. The f32 kernels multiply both halves of each
    operand (three TF32 products a product: 3xTF32).
    """
    hi = (w.view(torch.int32) & TF32_MASK).view(torch.float32)
    lo = ((w - hi).view(torch.int32) & TF32_MASK).view(torch.float32)
    return torch.stack((hi, lo))
