"""Spatial self-attention layer (port of ``skillful_nowcasting_tpu/layers/attention.py``).

1x1 Q/K/V convs without bias or spectral norm, a learnable scalar ``gamma``
(initialised to zero, as in the reference) and a residual connection.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import attention_fixed, attention_torch_compat, conv2d


class AttentionLayer(nn.Module):
    """Self-attention over an NCHW feature map ``(B, C, H, W)``."""

    def __init__(
        self,
        input_channels: int,
        output_channels: int,
        ratio_kq: int = 8,
        ratio_v: int = 8,
        mode: str = "torch_compat",
    ):
        super().__init__()
        if mode not in ("torch_compat", "fixed"):
            raise ValueError(f"unknown attention mode: {mode}")
        self.mode = mode
        self.query = conv2d(input_channels, output_channels // ratio_kq, 1, bias=False)
        self.key = conv2d(input_channels, output_channels // ratio_kq, 1, bias=False)
        self.value = conv2d(input_channels, output_channels // ratio_v, 1, bias=False)
        self.last_conv = conv2d(output_channels // ratio_v, output_channels, 1, bias=False)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        attend = attention_torch_compat if self.mode == "torch_compat" else attention_fixed
        out = attend(self.query(x), self.key(x), self.value(x))
        return self.gamma * self.last_conv(out) + x
