"""DGMR: the top-level model (port of ``skillful_nowcasting_tpu/dgmr.py``).

Constructor fields mirror the reference hyperparameters (the hub
``config.json`` contract). Submodule names match the reference state-dict
keys: ``conditioning_stack.*``, ``latent_stack.*``, ``sampler.*``,
``discriminator.*``. Eval mode serves nowcasts through the hand-written
kernels; train mode is the GAN training path of :mod:`..training`, where
every BatchNorm uses batch statistics and every spectral norm advances.

The model lives on the GPU unless the caller asks for the CPU with
``device="cpu"``; without CUDA the default raises instead of running on the
CPU. ``device`` is not a hyperparameter and stays out of ``config``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .hub.pretrained import HubMixin
from .layers.utils import refuse_coord
from .models.common import ContextConditioningStack, LatentConditioningStack
from .models.discriminators import Discriminator
from .models.generators import Sampler, ensemble_forward
from .profiling import span

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


class DGMR(nn.Module, HubMixin):
    """Deep Generative Model of Radar.

    ``forward`` maps context frames ``(B, 4, C, H, W)`` to one nowcast sample
    ``(B, forecast_steps, C, H, W)``; ``discriminate`` scores whole
    sequences. Parameters and buffers are built on ``device`` (default
    ``"cuda"``). ``num_spatial_layers`` / ``num_temporal_layers`` are the
    discriminator towers' depths (4 / 3 in the reference); small test configs
    shrink them, and like ``device`` they stay out of ``config``.
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
        num_spatial_layers: int = 4,
        num_temporal_layers: int = 3,
        device: torch.device | str = "cuda",
    ):
        refuse_coord(conv_type, "DGMR")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"DGMR(device={str(device)!r}): CUDA is not available; pass "
                "device='cpu' to build the model on the CPU"
            )
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
        self.discriminator = Discriminator(
            input_channels=input_channels,
            num_spatial_layers=num_spatial_layers,
            num_temporal_layers=num_temporal_layers,
        )
        self.to(device)

    def forward(
        self,
        x: torch.Tensor,
        z: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        space=None,
    ) -> torch.Tensor:
        """Generator forward: one nowcast sample; ``z`` is ``(1, 8C, H/32, W/32)``.

        ``space`` (see :func:`~.parallel.make_spatial_forward` and the
        H-sharded steps, which pass it) is this rank's
        :class:`~.parallel.spatial.SpaceLayout`: ``x`` and the nowcast are then
        its stripes of an H-sharded field, and the latent stack runs whole.
        """
        with span("dgmr.forward", device=x):
            states = self.conditioning_stack(x, space=space)
            latent = self.latent_stack(x, z=z, generator=generator)
            return self.sampler(states, latent, space=space)

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
        with span("dgmr.forward", device=x):
            return ensemble_forward(self, x, s, z=z, generator=generator)

    def discriminate(
        self,
        x: torch.Tensor,
        frame_indices: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        space=None,
    ) -> torch.Tensor:
        """Spatial + temporal scores ``(B, 2, 1)`` of full sequences ``(B, T, C, H, W)``.

        With ``space`` the sequences are this rank's stripes of H-sharded
        fields; the scores are the whole fields', the same on every rank of
        the space group.
        """
        return self.discriminator(x, frame_indices, generator, space)

    @property
    def config(self) -> dict:
        """Hub config dict (the Lightning ``save_hyperparameters`` contract)."""
        return {k: getattr(self, k) for k in HPARAM_FIELDS}
