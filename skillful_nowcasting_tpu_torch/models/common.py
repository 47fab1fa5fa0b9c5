"""Composite blocks and conditioning stacks, NCHW (NCDHW for 3-D DBlocks).

Port of ``skillful_nowcasting_tpu/models/common.py``. Module and parameter
names follow the reference torch state dict. The shortcut 1x1 convs that the
reference builds but never applies (GBlock and DBlock with equal channel
counts) are kept as parameters, so checkpoints load with ``strict=True``;
they are never evaluated, so their spectral-norm vectors never advance (the
JAX blocks call them with ``update_stats=False`` and drop the result).

Every block's ``forward(x, steps=None)`` takes the JAX ``sequential``
semantics: with ``steps=S`` the batch holds ``S`` slices (slice-major), and
in train mode each slice gets its own BatchNorm statistics and its own
spectral-norm sigma, as ``S`` sequential torch forwards would. In eval every
per-timestep block is batch-independent, so ``steps`` changes nothing there.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..hub.pretrained import HubMixin
from ..layers.attention import AttentionLayer
from ..layers.utils import get_conv_layer
from ..ops import (
    BatchNorm2d,
    avg_pool,
    conv2d,
    fold_gblock_variables,
    gblock_fused,
    space_to_depth,
    upsample_nearest_2x,
)


class GBlock(nn.Module):
    """Residual generator block, same resolution.

    Eval runs folded (BN into affines, SN into kernels) through
    :func:`~skillful_nowcasting_tpu_torch.ops.gblock_fused`: the hand-written
    kernel for CUDA tensors, the plain version for CPU tensors. Train mode
    has no fold (BN uses batch statistics) and runs the plain layers.
    """

    def __init__(
        self,
        input_channels: int = 12,
        output_channels: int = 12,
        conv_type: str = "standard",
        spectral_normalized_eps: float = 1e-4,
    ):
        super().__init__()
        conv = get_conv_layer(conv_type)
        eps = spectral_normalized_eps
        self.conv_1x1 = conv(input_channels, output_channels, 1, spectral_norm=True, sn_eps=eps)
        self.bn1 = BatchNorm2d(input_channels)
        self.first_conv_3x3 = conv(
            input_channels, input_channels, 3, padding=1, spectral_norm=True, sn_eps=eps
        )
        self.bn2 = BatchNorm2d(input_channels)
        self.last_conv_3x3 = conv(
            input_channels, output_channels, 3, padding=1, spectral_norm=True, sn_eps=eps
        )

    def forward(self, x: torch.Tensor, steps: Optional[int] = None) -> torch.Tensor:
        if not self.training:
            y = gblock_fused(x.permute(0, 2, 3, 1).contiguous(), *fold_gblock_variables(self))
            return y.permute(0, 3, 1, 2)
        sc = self.conv_1x1(x, steps) if x.shape[1] != self.last_conv_3x3.out_channels else x
        h = self.first_conv_3x3(torch.relu(self.bn1(x, steps)), steps)
        h = self.last_conv_3x3(torch.relu(self.bn2(h, steps)), steps)
        return h + sc


class UpsampleGBlock(nn.Module):
    """Residual generator block with 2x nearest upsampling; its 1x1 shortcut always applies."""

    def __init__(
        self,
        input_channels: int = 12,
        output_channels: int = 12,
        conv_type: str = "standard",
        spectral_normalized_eps: float = 1e-4,
    ):
        super().__init__()
        conv = get_conv_layer(conv_type)
        eps = spectral_normalized_eps
        self.conv_1x1 = conv(input_channels, output_channels, 1, spectral_norm=True, sn_eps=eps)
        self.bn1 = BatchNorm2d(input_channels)
        self.first_conv_3x3 = conv(
            input_channels, input_channels, 3, padding=1, spectral_norm=True, sn_eps=eps
        )
        self.bn2 = BatchNorm2d(input_channels)
        self.last_conv_3x3 = conv(
            input_channels, output_channels, 3, padding=1, spectral_norm=True, sn_eps=eps
        )

    def forward(self, x: torch.Tensor, steps: Optional[int] = None) -> torch.Tensor:
        sc = self.conv_1x1(upsample_nearest_2x(x), steps)
        y = upsample_nearest_2x(torch.relu(self.bn1(x, steps)))
        y = torch.relu(self.bn2(self.first_conv_3x3(y, steps), steps))
        return self.last_conv_3x3(y, steps) + sc


class DBlock(nn.Module):
    """Residual downsampling block, 2-D, or 3-D on NCDHW with ``conv_type="3d"``.

    Spectral norm keeps torch's default eps (1e-12).
    """

    def __init__(
        self,
        input_channels: int = 12,
        output_channels: int = 12,
        conv_type: str = "standard",
        first_relu: bool = True,
        keep_same_output: bool = False,
    ):
        super().__init__()
        conv = get_conv_layer(conv_type)
        self.use_sc_conv = input_channels != output_channels
        self.first_relu = first_relu
        self.keep_same_output = keep_same_output
        self.conv_1x1 = conv(input_channels, output_channels, 1, spectral_norm=True)
        self.first_conv_3x3 = conv(
            input_channels, output_channels, 3, padding=1, spectral_norm=True
        )
        self.last_conv_3x3 = conv(
            output_channels, output_channels, 3, padding=1, spectral_norm=True
        )

    def forward(self, x: torch.Tensor, steps: Optional[int] = None) -> torch.Tensor:
        if self.use_sc_conv:
            x1 = self.conv_1x1(x, steps)
            if not self.keep_same_output:
                x1 = avg_pool(x1, 2)
        else:
            x1 = x
        h = torch.relu(x) if self.first_relu else x
        h = self.last_conv_3x3(torch.relu(self.first_conv_3x3(h, steps)), steps)
        if not self.keep_same_output:
            h = avg_pool(h, 2)
        return x1 + h


class LBlock(nn.Module):
    """Channel-growing residual block of the latent stack; no BN, no spectral norm."""

    def __init__(
        self,
        input_channels: int = 12,
        output_channels: int = 12,
        conv_type: str = "standard",
    ):
        super().__init__()
        conv = get_conv_layer(conv_type)
        if input_channels < output_channels:
            self.conv_1x1 = conv(input_channels, output_channels - input_channels, 1)
        else:
            self.conv_1x1 = None
        self.first_conv_3x3 = conv(input_channels, output_channels, 3, padding=1)
        self.last_conv_3x3 = conv(output_channels, output_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sc = x if self.conv_1x1 is None else torch.cat([x, self.conv_1x1(x)], dim=1)
        h = self.last_conv_3x3(torch.relu(self.first_conv_3x3(torch.relu(x))))
        return h + sc


class ContextConditioningStack(nn.Module, HubMixin):
    """Encode context frames ``(B, T, C, H, W)`` into 4 conditioning states.

    Returns NCHW states ordered largest spatial first:
    ``(B, oc/8, H/8, W/8), ..., (B, oc, H/64, W/64)`` for one input channel.
    The DBlocks see the context steps T-major, ``(T*B, ...)`` with
    ``steps=T``, as the JAX stack's ``(T, B, ...)`` sequential axis.
    """

    def __init__(
        self,
        input_channels: int = 1,
        output_channels: int = 768,
        num_context_steps: int = 4,
        conv_type: str = "standard",
    ):
        super().__init__()
        self.input_channels = input_channels
        self.output_channels = output_channels
        self.num_context_steps = num_context_steps
        self.conv_type = conv_type
        conv = get_conv_layer(conv_type)
        oc, ic, ncs = output_channels, input_channels, num_context_steps
        self.d1 = DBlock(4 * ic, ((oc // 4) * ic) // ncs, conv_type)
        self.d2 = DBlock(((oc // 4) * ic) // ncs, ((oc // 2) * ic) // ncs, conv_type)
        self.d3 = DBlock(((oc // 2) * ic) // ncs, (oc * ic) // ncs, conv_type)
        self.d4 = DBlock((oc * ic) // ncs, (oc * 2 * ic) // ncs, conv_type)
        self.conv1 = conv((oc // 4) * ic, (oc // 8) * ic, 3, padding=1, spectral_norm=True)
        self.conv2 = conv((oc // 2) * ic, (oc // 4) * ic, 3, padding=1, spectral_norm=True)
        self.conv3 = conv(oc * ic, (oc // 2) * ic, 3, padding=1, spectral_norm=True)
        self.conv4 = conv(oc * 2 * ic, oc * ic, 3, padding=1, spectral_norm=True)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        b, t = x.shape[:2]
        h = space_to_depth(x, 2).transpose(0, 1).flatten(0, 1)  # (T*B, 4C, H/2, W/2)
        states = []
        for block, mix in ((self.d1, self.conv1), (self.d2, self.conv2),
                           (self.d3, self.conv3), (self.d4, self.conv4)):
            h = block(h, steps=t)
            # (T*B, c, h, w) -> (B, c, T, h, w) -> (B, c*T, h, w): channel order (c, t).
            s = h.unflatten(0, (t, b)).permute(1, 2, 0, 3, 4).flatten(1, 2)
            states.append(torch.relu(mix(s)))
        return tuple(states)


class LatentConditioningStack(nn.Module, HubMixin):
    """Draw and transform the latent z.

    Quirk Q2: z has batch **1** whatever the input batch, so every batch
    element shares one draw. ``shape`` is ``(C, H, W)`` of the latent; the
    output is ``(1, output_channels, H, W)`` (or batch ``S`` for ``S`` given
    latents). Pass ``z`` (NCHW) for deterministic results, or a
    ``torch.Generator`` for the draw.
    """

    def __init__(
        self,
        shape: Tuple[int, int, int] = (8, 8, 8),
        output_channels: int = 768,
    ):
        super().__init__()
        self.shape = tuple(shape)
        self.output_channels = output_channels
        c, oc = shape[0], output_channels
        self.conv_3x3 = conv2d(c, c, 3, padding=1, spectral_norm=True)
        self.l_block1 = LBlock(c, oc // 32)
        self.l_block2 = LBlock(oc // 32, oc // 16)
        self.l_block3 = LBlock(oc // 16, oc // 4)
        self.att_block = AttentionLayer(oc // 4, oc // 4)
        self.l_block4 = LBlock(oc // 4, oc)

    def forward(
        self,
        x: Optional[torch.Tensor] = None,
        z: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        if z is None:
            z = draw_latents(self.shape, 1, generator, self.conv_3x3.bias)
        if x is not None:
            z = z.to(device=x.device, dtype=x.dtype)
        z = self.l_block3(self.l_block2(self.l_block1(self.conv_3x3(z))))
        return self.l_block4(self.att_block(z))


def draw_latents(
    shape: Tuple[int, int, int],
    num: int,
    generator: Optional[torch.Generator],
    like: torch.Tensor,
) -> torch.Tensor:
    """``num`` standard-normal latents of NCHW ``shape``, on ``like``'s device and dtype.

    They are drawn on the generator's own device (CPU by default) and then
    moved, so one seed gives the same latents for a model on any device.
    """
    device = generator.device if generator is not None else torch.device("cpu")
    z = torch.randn((num, *shape), generator=generator, device=device)
    return z.to(device=like.device, dtype=like.dtype)
