"""Training losses (port of the training-critical part of ``skillful_nowcasting_tpu/losses.py``).

Videos are NTCHW ``(B, T, C, H, W)``.

* :func:`loss_hinge_disc` / :func:`loss_hinge_gen`: the GAN hinge losses.
* :func:`weight_fn`: quirk Q4, ``max(y + 1, cap)``, a floor at ``cap``
  rather than the paper's ceiling; reproduced exactly.
* :class:`GridCellLoss`: quirk Q3, the reference normalization
  ``diff.norm(p=1) / T * H * W`` evaluates left to right as
  ``(||diff||_1 / T) * H * W``; ``grid_lambda = 20`` was tuned against that
  scale, so it is reproduced exactly.

SSIM, MS-SSIM, focal, TV, GDL and ``get_loss`` are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def loss_hinge_disc(score_generated: torch.Tensor, score_real: torch.Tensor) -> torch.Tensor:
    """Discriminator hinge loss: ``mean(relu(1 - real)) + mean(relu(1 + generated))``."""
    return torch.relu(1.0 - score_real).mean() + torch.relu(1.0 + score_generated).mean()


def loss_hinge_gen(score_generated: torch.Tensor) -> torch.Tensor:
    """Generator hinge loss: ``-mean(generated)``."""
    return -score_generated.mean()


def weight_fn(y: torch.Tensor, precip_weight_cap: float = 24.0) -> torch.Tensor:
    """Grid-cell loss weights: ``max(y + 1, cap)`` (quirk Q4)."""
    return torch.clamp(y + 1.0, min=precip_weight_cap)


class GridCellLoss:
    """Weighted L1 between the mean generated sample and the target, ``(||d||_1 / T) * H * W``."""

    def __init__(self, weight_fn: Optional[Callable] = None, precip_weight_cap: float = 24.0):
        self.weight_fn = (lambda y: weight_fn(y, precip_weight_cap)) if weight_fn else None

    def __call__(self, generated_images: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        difference = generated_images - targets
        if self.weight_fn is not None:
            difference = difference * self.weight_fn(targets)
        t, h, w = targets.shape[1], targets.shape[3], targets.shape[4]
        return difference.abs().sum() / t * h * w
