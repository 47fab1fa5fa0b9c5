"""Nearest-neighbour 2x upsampling (port of ``skillful_nowcasting_tpu/ops/resize.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Repeat each pixel 2x2 on ``(N, C, H, W)`` (torch ``nn.Upsample(scale_factor=2)``)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
