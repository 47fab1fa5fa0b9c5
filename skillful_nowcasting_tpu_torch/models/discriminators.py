"""Spatial, temporal and combined discriminators, NCHW.

Port of ``skillful_nowcasting_tpu/models/discriminators.py``. The towers
fold frames into the conv batch with ``steps`` set to the frame count, so
train-mode spectral norm and the per-frame BatchNorm1d -> Linear heads keep
the reference's per-frame semantics.

Quirk Q5: the spatial discriminator samples ``num_timesteps`` frame indices
uniformly WITH replacement, from an explicit ``torch.Generator`` (drawn on
the generator's device, the CPU by default) or given as ``frame_indices``.

With ``space=`` (a :class:`~..parallel.spatial.SpaceLayout`) the sequences
are this rank's stripes of H-sharded fields. Neither discriminator crops:
both towers run on the stripes, their convs exchanging halos, until a level
is too thin to pool on its stripes (an odd count of rows, one included).
That level is gathered whole on every rank (``space.gather``) and the rest
of the tower runs on it alike. The heads' ``sum(relu(rep), (H, W))`` adds
up over the space group where the tower ended on stripes, so the scores
come out the same on every rank of a space group.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..hub.pretrained import HubMixin
from ..ops import BatchNorm1d, avg_pool, dense, space_to_depth
from .common import DBlock


def _head(rep: torch.Tensor, steps: int, bn: nn.Module, fc: nn.Module, space=None) -> torch.Tensor:
    """``(S*B, C, h, w)`` -> per-frame relu-sum, BN, SN linear; summed over S: ``(B, 1, 1)``."""
    rep = torch.relu(rep).sum(dim=(2, 3))
    if space is not None:  # the tower ended on stripes
        rep = space.sum(rep)
    rep = fc(bn(rep, steps), steps)  # (S*B, 1)
    return rep.unflatten(0, (steps, -1)).sum(dim=0)[:, None, :]


def _whole_if_thin(x: torch.Tensor, space):
    """``(x, space)``, or ``x`` gathered whole and ``None`` where its stripes cannot be halved."""
    if space is None or x.shape[-2] % 2 == 0:
        return x, space
    return space.gather(x), None


def _tower(x: torch.Tensor, blocks, steps, space):
    """The DBlocks in turn, a level gathered whole before a block that pools it too thin."""
    for block in blocks:
        if not block.keep_same_output:
            x, space = _whole_if_thin(x, space)
        x = block(x, steps, space)
    return x, space


class SpatialDiscriminator(nn.Module, HubMixin):
    """Per-frame discriminator on sampled frames; ``(B, T, C, H, W)`` -> ``(B, 1, 1)``."""

    def __init__(
        self,
        input_channels: int = 12,
        num_timesteps: int = 8,
        num_layers: int = 4,
        conv_type: str = "standard",
    ):
        super().__init__()
        self.input_channels = input_channels
        self.num_timesteps = num_timesteps
        self.num_layers = num_layers
        self.conv_type = conv_type
        ic, chn = input_channels, 24
        self.d1 = DBlock(4 * ic, 2 * chn * ic, conv_type, first_relu=False)
        blocks = []
        for _ in range(num_layers):
            chn *= 2
            blocks.append(DBlock(chn * ic, 2 * chn * ic, conv_type))
        self.intermediate_dblocks = nn.ModuleList(blocks)
        self.d6 = DBlock(2 * chn * ic, 2 * chn * ic, conv_type, keep_same_output=True)
        self.bn = BatchNorm1d(2 * chn * ic)
        self.fc = dense(2 * chn * ic, 1, spectral_norm=True)

    def forward(
        self,
        x: torch.Tensor,
        frame_indices: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        space=None,
    ) -> torch.Tensor:
        if frame_indices is None:
            frame_indices = draw_frames(self.num_timesteps, x.shape[1], generator)
        s = len(frame_indices)
        frames = x[:, frame_indices.to(x.device)].transpose(0, 1).flatten(0, 1)  # (S*B, C, H, W)
        frames, space = _whole_if_thin(frames, space)
        rep, space = _whole_if_thin(avg_pool(frames, 2), space)
        rep = space_to_depth(rep, 2)
        rep, space = _tower(rep, [self.d1, *self.intermediate_dblocks, self.d6], s, space)
        return _head(rep, s, self.bn, self.fc, space)


class TemporalDiscriminator(nn.Module, HubMixin):
    """3-D stem and a per-remaining-timestep tower; ``(B, T, C, H, W)`` -> ``(B, 1, 1)``."""

    def __init__(self, input_channels: int = 12, num_layers: int = 3, conv_type: str = "standard"):
        super().__init__()
        self.input_channels = input_channels
        self.num_layers = num_layers
        self.conv_type = conv_type
        ic, chn = input_channels, 48
        self.d1 = DBlock(4 * ic, chn * ic, conv_type="3d", first_relu=False)
        self.d2 = DBlock(chn * ic, 2 * chn * ic, conv_type="3d")
        blocks = []
        for _ in range(num_layers):
            chn *= 2
            blocks.append(DBlock(chn * ic, 2 * chn * ic, conv_type))
        self.intermediate_dblocks = nn.ModuleList(blocks)
        self.d_last = DBlock(2 * chn * ic, 2 * chn * ic, conv_type, keep_same_output=True)
        self.bn = BatchNorm1d(2 * chn * ic)
        self.fc = dense(2 * chn * ic, 1, spectral_norm=True)

    def forward(self, x: torch.Tensor, space=None) -> torch.Tensor:
        # AvgPool3d((1, 2, 2)): spatial halving only, then pixel unshuffle.
        x, space = _whole_if_thin(x, space)
        x, space = _whole_if_thin(avg_pool(x.flatten(0, 1), 2).unflatten(0, x.shape[:2]), space)
        x = space_to_depth(x, 2)
        x, space = _tower(x.transpose(1, 2), [self.d1, self.d2], None, space)  # NCDHW; T 22 -> 5
        t = x.shape[2]
        x = x.permute(2, 0, 1, 3, 4).flatten(0, 1)  # (T'*B, C, h, w), T-major
        x, space = _tower(x, [*self.intermediate_dblocks, self.d_last], t, space)
        return _head(x, t, self.bn, self.fc, space)


class Discriminator(nn.Module, HubMixin):
    """Spatial and temporal scores concatenated: ``(B, 2, 1)``, spatial first (quirk Q7)."""

    def __init__(
        self,
        input_channels: int = 12,
        num_spatial_frames: int = 8,
        conv_type: str = "standard",
        num_spatial_layers: int = 4,
        num_temporal_layers: int = 3,
    ):
        super().__init__()
        self.input_channels = input_channels
        self.num_spatial_frames = num_spatial_frames
        self.conv_type = conv_type
        self.num_spatial_layers = num_spatial_layers
        self.num_temporal_layers = num_temporal_layers
        self.spatial_discriminator = SpatialDiscriminator(
            input_channels, num_spatial_frames, num_spatial_layers, conv_type
        )
        self.temporal_discriminator = TemporalDiscriminator(
            input_channels, num_temporal_layers, conv_type
        )

    def forward(
        self,
        x: torch.Tensor,
        frame_indices: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        space=None,
    ) -> torch.Tensor:
        spatial = self.spatial_discriminator(x, frame_indices, generator, space)
        return torch.cat([spatial, self.temporal_discriminator(x, space)], dim=1)


def draw_frames(num: int, length: int, generator: Optional[torch.Generator]) -> torch.Tensor:
    """``num`` frame indices in ``[0, length)``, with replacement, on the generator's device."""
    device = generator.device if generator is not None else torch.device("cpu")
    return torch.randint(0, length, (num,), generator=generator, device=device)
