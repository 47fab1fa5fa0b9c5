"""Pixel unshuffle / shuffle (port of ``skillful_nowcasting_tpu/ops/pixel.py``).

The JAX functions reproduce torch's channel order in NHWC (``c*r*r + i*r + j``);
in NCHW that order is torch's own, so these are the stock operators. They
accept any leading dims, e.g. ``(B, T, C, H, W)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def space_to_depth(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """PixelUnshuffle: ``(..., C, H, W) -> (..., C*r*r, H/r, W/r)``."""
    return F.pixel_unshuffle(x, r)


def depth_to_space(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """PixelShuffle: ``(..., C*r*r, H, W) -> (..., C, H*r, W*r)``."""
    return F.pixel_shuffle(x, r)
