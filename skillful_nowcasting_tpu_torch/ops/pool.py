"""Average pooling (port of ``skillful_nowcasting_tpu/ops/pool.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def avg_pool(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """VALID average pooling with stride ``window``, floor output size.

    ``(N, C, H, W)`` pools H and W; ``(N, C, D, H, W)`` pools D as well (the
    temporal discriminator's 3-D DBlocks: T goes 22 -> 11 -> 5). The CPU
    has no bf16 3-D pooling: there a bf16 input is pooled in f32 and rounded
    once, which is what the card's bf16 pooling computes.
    """
    if x.ndim == 5:
        if x.dtype == torch.bfloat16 and x.device.type == "cpu":
            return F.avg_pool3d(x.float(), window).to(x.dtype)
        return F.avg_pool3d(x, window)
    return F.avg_pool2d(x, window)
