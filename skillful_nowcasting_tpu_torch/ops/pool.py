"""2x2 average pooling (port of the 2-D case of ``skillful_nowcasting_tpu/ops/pool.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def avg_pool(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """VALID average pooling with stride ``window`` on ``(N, C, H, W)``, floor output size."""
    return F.avg_pool2d(x, window)
