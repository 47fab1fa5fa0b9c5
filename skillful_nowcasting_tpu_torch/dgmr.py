"""DGMR: the generator half of the top-level model (port of ``skillful_nowcasting_tpu/dgmr.py``).

Constructor fields mirror the reference hyperparameters (the hub
``config.json`` contract). Submodule names match the reference state-dict
keys: ``conditioning_stack.*``, ``latent_stack.*``, ``sampler.*``. The
discriminator and training are not ported yet, so the model runs in eval
mode only (call ``.eval()``; train mode raises ``NotImplementedError``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .models.common import ContextConditioningStack, LatentConditioningStack
from .models.generators import Sampler, ensemble_forward

HPARAM_FIELDS = (
    "forecast_steps",
    "input_channels",
    "output_shape",
    "gen_lr",
    "disc_lr",
    "visualize",
    "conv_type",
    "num_samples",
    "grid_lambda",
    "beta1",
    "beta2",
    "latent_channels",
    "context_channels",
    "generation_steps",
    "precip_weight_cap",
)


class DGMR(nn.Module):
    """Deep Generative Model of Radar, generator half.

    ``forward`` maps context frames ``(B, 4, C, H, W)`` to one nowcast sample
    ``(B, forecast_steps, C, H, W)``.
    """

    def __init__(
        self,
        forecast_steps: int = 18,
        input_channels: int = 1,
        output_shape: int = 256,
        gen_lr: float = 5e-5,
        disc_lr: float = 2e-4,
        visualize: bool = False,
        conv_type: str = "standard",
        num_samples: int = 6,
        grid_lambda: float = 20.0,
        beta1: float = 0.0,
        beta2: float = 0.999,
        latent_channels: int = 768,
        context_channels: int = 384,
        generation_steps: int = 6,
        precip_weight_cap: float = 24.0,
    ):
        super().__init__()
        self.forecast_steps = forecast_steps
        self.input_channels = input_channels
        self.output_shape = output_shape
        self.gen_lr = gen_lr
        self.disc_lr = disc_lr
        self.visualize = visualize
        self.conv_type = conv_type
        self.num_samples = num_samples
        self.grid_lambda = grid_lambda
        self.beta1 = beta1
        self.beta2 = beta2
        self.latent_channels = latent_channels
        self.context_channels = context_channels
        self.generation_steps = generation_steps
        self.precip_weight_cap = precip_weight_cap

        self.conditioning_stack = ContextConditioningStack(
            input_channels=input_channels,
            output_channels=context_channels,
            conv_type=conv_type,
        )
        self.latent_stack = LatentConditioningStack(
            shape=(8 * input_channels, output_shape // 32, output_shape // 32),
            output_channels=latent_channels,
        )
        self.sampler = Sampler(
            forecast_steps=forecast_steps,
            latent_channels=latent_channels,
            context_channels=context_channels,
        )

    def forward(
        self,
        x: torch.Tensor,
        z: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Generator forward: one nowcast sample; ``z`` is ``(1, 8C, H/32, W/32)``."""
        states = self.conditioning_stack(x)
        latent = self.latent_stack(x, z=z, generator=generator)
        return self.sampler(states, latent)

    def generate_ensemble(
        self,
        x: torch.Tensor,
        num_samples: Optional[int] = None,
        z: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Shared-context S-sample ensemble ``(S, B, T, C, H, W)``.

        Equals S independent forwards with the same latents, but runs the
        conditioning stack once and one sampler call at batch ``S * B``.
        """
        s = num_samples if num_samples is not None else self.num_samples
        return ensemble_forward(self, x, s, z=z, generator=generator)

    @property
    def config(self) -> dict:
        """Hub config dict (the Lightning ``save_hyperparameters`` contract)."""
        return {k: getattr(self, k) for k in HPARAM_FIELDS}
