"""Operand layouts the bf16 kernels' TMA loads need (``csrc/hopper.cuh``).

TMA reads from addresses and strides that are multiples of 16 bytes, and
``wgmma`` takes the weights as K-major rows: the kernels' wrappers prepare
their operands with these.
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
