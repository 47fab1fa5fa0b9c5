"""Generator: ConvGRU sampler pyramid + composition wrapper, NCHW.

Port of ``skillful_nowcasting_tpu/models/generators.py``. Each of the four
Sampler levels runs one ConvGRU rollout (in eval the hand-written rollout
kernel on CUDA tensors), then the 1x1 conv, GBlock (in eval the hand-written
GBlock kernel on CUDA tensors) and UpsampleGBlock on all timesteps at once,
timesteps folded T-major into the batch with ``steps=T``: in train mode each
timestep gets its own BatchNorm statistics and spectral-norm sigma, as the
reference's per-timestep loops give. The bottom level's input is the same
latent at every step, so it takes the ConvGRU's static-input path.

The JAX Sampler's ``train_t_chunks`` (remat over T-chunks, for a 16 GB
chip) is not ported: the full-width train step fits the card without it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..hub.pretrained import HubMixin
from ..layers.convgru import ConvGRU
from ..ops import BatchNorm2d, conv2d, depth_to_space
from ..profiling import span
from .common import GBlock, UpsampleGBlock, draw_latents


class Sampler(nn.Module, HubMixin):
    """Recurrent decoder from conditioning states and latent.

    ``forward(states, latent)`` takes the four NCHW conditioning states
    (largest spatial first) and the latent ``(1 or B, latent_channels, h, w)``
    and returns ``(B, forecast_steps, output_channels, H, W)``. With
    ``space=`` the states and the output are this rank's stripes of an
    H-sharded field and the latent is whole; the layout goes to each level's
    ConvGRU, GBlock and UpsampleGBlock, and the head
    (BN-ReLU-1x1-``depth_to_space``) runs on the stripe.
    """

    def __init__(
        self,
        forecast_steps: int = 18,
        latent_channels: int = 768,
        context_channels: int = 384,
        output_channels: int = 1,
    ):
        super().__init__()
        self.forecast_steps = forecast_steps
        self.latent_channels = latent_channels
        self.context_channels = context_channels
        self.output_channels = output_channels
        lc, cc = latent_channels, context_channels
        suffixes = ("", "_2", "_3", "_4")
        for i in range(4):
            div = 2**i
            setattr(self, f"convGRU{i + 1}", ConvGRU(lc // div + cc // div, cc // div, 3))
            setattr(
                self,
                f"gru_conv_1x1{suffixes[i]}",
                conv2d(cc // div, lc // div, 1, spectral_norm=True),
            )
            setattr(self, f"g{i + 1}", GBlock(lc // div, lc // div))
            setattr(self, f"up_g{i + 1}", UpsampleGBlock(lc // div, lc // (div * 2)))
        self.bn = BatchNorm2d(lc // 16)
        self.conv_1x1 = conv2d(lc // 16, 4 * output_channels, 1, spectral_norm=True)

    def forward(
        self, conditioning_states: Sequence[torch.Tensor], latent: torch.Tensor, space=None
    ) -> torch.Tensor:
        with span("dgmr.sampler", device=latent):
            batch = conditioning_states[0].shape[0]
            # Quirk Q2: the latent has batch 1; repeat it over the real batch.
            latent = latent.repeat(batch // latent.shape[0], 1, 1, 1)
            suffixes = ("", "_2", "_3", "_4")
            h = latent
            # Level order: smallest scale first (quirk Q6); state 4 feeds the first GRU.
            for i in range(4):
                gru = getattr(self, f"convGRU{i + 1}")
                init_state = conditioning_states[3 - i]
                if i == 0:
                    seq = gru(h, init_state, n_steps=self.forecast_steps, x_static=True,
                              space=space)
                else:
                    seq = gru(h, init_state, space=space)
                t, b = seq.shape[:2]
                x = getattr(self, f"gru_conv_1x1{suffixes[i]}")(seq.flatten(0, 1), t, space)
                x = getattr(self, f"g{i + 1}")(x, t, space)
                x = getattr(self, f"up_g{i + 1}")(x, t, space)
                h = x.unflatten(0, (t, b))  # (T, B, C, H, W)
            # Output head per timestep: BN -> ReLU -> SN 1x1 -> PixelShuffle(2).
            x = self.conv_1x1(torch.relu(self.bn(h.flatten(0, 1), t)), t, space)
            x = depth_to_space(x, 2).unflatten(0, (t, b))
            return x.transpose(0, 1)  # (B, T, C, H, W)


def ensemble_forward(
    mdl,
    x: torch.Tensor,
    num_samples: int,
    z: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """S-sample ensemble sharing one conditioning-stack pass (eval only).

    Every sample has its own batch-1 latent shared across the batch (quirk
    Q2); the S samples fold into the sampler's batch sample-major, so the
    result equals S separate forwards with the same latents.

    Args:
        mdl: module exposing ``conditioning_stack``/``latent_stack``/``sampler``.
        x: context frames ``(B, T_in, C, H, W)``.
        num_samples: ensemble size S.
        z: optional fixed latents ``(S, 8C, H/32, W/32)``; drawn from
            ``generator`` otherwise.

    Returns:
        ``(S, B, T_out, C, H, W)`` ensemble.
    """
    s, b = num_samples, x.shape[0]
    states = mdl.conditioning_stack(x)
    if z is None:
        z = draw_latents(mdl.latent_stack.shape, s, generator, x)
    latent = mdl.latent_stack(x, z=z)  # (S, latent_channels, h, w)
    latent = latent.repeat_interleave(b, dim=0)  # sample-major (S*B, ...)
    states = tuple(st.repeat(s, 1, 1, 1) for st in states)
    out = mdl.sampler(states, latent)  # (S*B, T, C, H, W)
    return out.unflatten(0, (s, b))


class Generator(nn.Module, HubMixin):
    """``sampler(conditioning_stack(x), latent_stack(x))``."""

    def __init__(self, conditioning_stack: nn.Module, latent_stack: nn.Module, sampler: nn.Module):
        super().__init__()
        self.conditioning_stack = conditioning_stack
        self.latent_stack = latent_stack
        self.sampler = sampler

    def forward(
        self,
        x: torch.Tensor,
        z: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        with span("dgmr.forward", device=x):
            states = self.conditioning_stack(x)
            return self.sampler(states, self.latent_stack(x, z=z, generator=generator))

    def generate_ensemble(
        self,
        x: torch.Tensor,
        num_samples: int,
        z: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Shared-context S-sample ensemble; see :func:`ensemble_forward`."""
        with span("dgmr.forward", device=x):
            return ensemble_forward(self, x, num_samples, z=z, generator=generator)
