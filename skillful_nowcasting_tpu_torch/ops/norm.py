"""Eval BatchNorm: port of ``skillful_nowcasting_tpu/ops/norm.py:TorchBatchNorm``.

In eval mode ``TorchBatchNorm(train=False)`` is exactly ``nn.BatchNorm2d`` with
running statistics (keys ``weight``, ``bias``, ``running_mean``,
``running_var``, ``num_batches_tracked``). Train mode, with its per-timestep
statistics and closed-form sequential EMA, is not ported yet and raises.
"""

from __future__ import annotations

import torch
from torch import nn


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` that refuses train mode."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "train-mode BatchNorm is not ported yet; call .eval() on the model"
            )
        return super().forward(x)
