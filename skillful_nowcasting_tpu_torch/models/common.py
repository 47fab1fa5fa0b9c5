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

The blocks and the context stack also take ``space=`` (a
:class:`~..parallel.spatial.SpaceLayout`, in eval and in train mode): ``x``
is then this rank's stripe of an H-sharded field. Their 3x3 convs exchange
halo rows, the eval GBlock kernel runs on a window of rows
(:meth:`GBlock.forward`), and everything else (1x1 convs, BatchNorm,
pooling, pixel shuffles, upsampling) runs on the stripe as it is: a train
BatchNorm takes its statistics over the group its ``sync_batch_norm`` block
gives it, and a pooling DBlock needs an even count of rows on each rank
(the discriminators gather a thinner level whole first). Without it they
run the dense code.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..hub.pretrained import HubMixin
from ..layers.attention import AttentionLayer
from ..layers.utils import get_conv_layer, refuse_coord
from ..ops import (
    BatchNorm2d,
    avg_pool,
    conv2d,
    fold_gblock_variables,
    gblock_fused,
    space_to_depth,
    upsample_nearest_2x,
)
from ..profiling import span


class GBlock(nn.Module):
    """Residual generator block, same resolution.

    Eval runs folded (BN into affines, SN into kernels) through
    :func:`~skillful_nowcasting_tpu_torch.ops.gblock_fused`: the hand-written
    kernel for CUDA tensors, the plain version for CPU tensors. The fold is
    computed in the parameters' dtype; the kernels are cast to ``x``'s dtype
    and the affines are not, so a bf16 ``x`` runs the bf16 kernel. Train mode
    has no fold (BN uses batch statistics) and runs the plain layers.

    Under a space layout the kernel runs on the stripe and the 2 rows a side
    that its two 3x3 convs reach (:func:`~..parallel.spatial.halo_window`,
    clipped to the field), and those rows are cropped from its output: the
    rows they spoil at a window's inner edge are the borrowed ones, and at
    the field's edge the kernel's SAME padding is the field's.
    """

    def __init__(
        self,
        input_channels: int = 12,
        output_channels: int = 12,
        conv_type: str = "standard",
        spectral_normalized_eps: float = 1e-4,
    ):
        refuse_coord(conv_type, "GBlock")
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

    def forward(self, x: torch.Tensor, steps: Optional[int] = None, space=None) -> torch.Tensor:
        if not self.training:
            if space is None:
                return self._fused(x)
            xw, top, bottom = space.window(x, 2)
            return self._fused(xw)[:, :, top:xw.shape[2] - bottom]
        sc = self.conv_1x1(x, steps, space) if x.shape[1] != self.last_conv_3x3.out_channels else x
        h = self.first_conv_3x3(torch.relu(self.bn1(x, steps)), steps, space)
        h = self.last_conv_3x3(torch.relu(self.bn2(h, steps)), steps, space)
        return h + sc

    def _fused(self, x: torch.Tensor) -> torch.Tensor:
        with span("dgmr.derive.gblock", device=x):
            folded = fold_gblock_variables(self, x.dtype)
        return gblock_fused(x.permute(0, 2, 3, 1).contiguous(), *folded).permute(0, 3, 1, 2)


class UpsampleGBlock(nn.Module):
    """Residual generator block with 2x nearest upsampling; its 1x1 shortcut always applies."""

    def __init__(
        self,
        input_channels: int = 12,
        output_channels: int = 12,
        conv_type: str = "standard",
        spectral_normalized_eps: float = 1e-4,
    ):
        refuse_coord(conv_type, "UpsampleGBlock")
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

    def forward(self, x: torch.Tensor, steps: Optional[int] = None, space=None) -> torch.Tensor:
        with span("dgmr.upsample_gblock", device=x):
            sc = self.conv_1x1(upsample_nearest_2x(x), steps, space)
            y = upsample_nearest_2x(torch.relu(self.bn1(x, steps)))
            y = torch.relu(self.bn2(self.first_conv_3x3(y, steps, space), steps))
            return self.last_conv_3x3(y, steps, space) + sc


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
        refuse_coord(conv_type, "DBlock")
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

    def forward(self, x: torch.Tensor, steps: Optional[int] = None, space=None) -> torch.Tensor:
        if self.use_sc_conv:
            x1 = self.conv_1x1(x, steps, space)
            if not self.keep_same_output:
                x1 = avg_pool(x1, 2)
        else:
            x1 = x
        h = torch.relu(x) if self.first_relu else x
        h = self.last_conv_3x3(torch.relu(self.first_conv_3x3(h, steps, space)), steps, space)
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

    def forward(self, x: torch.Tensor, space=None) -> Tuple[torch.Tensor, ...]:
        with span("dgmr.context", device=x):
            b, t = x.shape[:2]
            h = space_to_depth(x, 2).transpose(0, 1).flatten(0, 1)  # (T*B, 4C, H/2, W/2)
            states = []
            for block, mix in ((self.d1, self.conv1), (self.d2, self.conv2),
                               (self.d3, self.conv3), (self.d4, self.conv4)):
                h = block(h, steps=t, space=space)
                # (T*B, c, h, w) -> (B, c, T, h, w) -> (B, c*T, h, w): channel order (c, t).
                s = h.unflatten(0, (t, b)).permute(1, 2, 0, 3, 4).flatten(1, 2)
                states.append(torch.relu(mix(s, space=space)))
            return tuple(states)


class LatentConditioningStack(nn.Module, HubMixin):
    """Draw and transform the latent z.

    Quirk Q2: z has batch **1** whatever the input batch, so every batch
    element shares one draw. ``shape`` is ``(C, H, W)`` of the latent; the
    output is ``(1, output_channels, H, W)`` (or batch ``S`` for ``S`` given
    latents). Pass ``z`` (NCHW) for deterministic results, or a
    ``torch.Generator`` for the draw. It reads no input rows, so a sharded
    forward runs it whole on every rank, from the same ``z`` or seed.
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
        with span("dgmr.latent", device=self.conv_3x3.bias):
            if z is None:
                z = draw_latents(self.shape, 1, generator, self.conv_3x3.bias)
            if x is not None:
                z = z.to(device=x.device, dtype=x.dtype)
            z = self.l_block3(self.l_block2(self.l_block1(self.conv_3x3(z))))
            return self.l_block4(self.att_block(z))


DRAWS_NOT_SHARED = (
    "every rank must pass the same generator (equally seeded) or the same draws (z), as JAX "
    "passes every device one key: without them each process draws from its own global RNG, "
    "and the ranks would compute with different latents and frames"
)


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
