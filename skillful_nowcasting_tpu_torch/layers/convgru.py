"""Convolutional GRU, eval path (port of ``skillful_nowcasting_tpu/layers/convgru.py``).

A cell of three spectrally normalized 3x3 convs (read gate, update gate,
candidate) over the channel concat ``[x; h]``:

    r = sigmoid(conv_r([x; h]));  u = sigmoid(conv_u([x; h]))
    c = relu(conv_c([x; r * h]));  h' = u * h + (1 - u) * c

:class:`ConvGRU` splits each gate conv into its input part and its hidden
part (the conv is linear over the concat). The input parts of all steps run
up front as one fused 3C-output ``F.conv2d`` (once only for a static input);
the hidden parts run inside :func:`~skillful_nowcasting_tpu_torch.ops.convgru_rollout`,
which launches the hand-written kernel for CUDA tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv2d, convgru_rollout


class ConvGRUCell(nn.Module):
    """Single ConvGRU step on NCHW inputs.

    ``input_channels`` is the total concatenated channel count (x + h), as in
    the reference.
    """

    def __init__(
        self, input_channels: int, output_channels: int, kernel_size: int = 3, sn_eps: float = 1e-4
    ):
        super().__init__()
        self.input_channels = input_channels
        self.output_channels = output_channels
        pad = (kernel_size - 1) // 2
        for name in ("read_gate_conv", "update_gate_conv", "output_conv"):
            conv = conv2d(
                input_channels, output_channels, kernel_size, padding=pad,
                spectral_norm=True, sn_eps=sn_eps,
            )
            setattr(self, name, conv)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One step; returns ``(out, new_state)`` like the reference (both the same tensor)."""
        xh = torch.cat([x, h], dim=1)
        read = torch.sigmoid(self.read_gate_conv(xh))
        update = torch.sigmoid(self.update_gate_conv(xh))
        c = torch.relu(self.output_conv(torch.cat([x, read * h], dim=1)))
        out = update * h + (1.0 - update) * c
        return out, out


class ConvGRU(nn.Module):
    """Unrolls a shared :class:`ConvGRUCell` over time (eval).

    Input sequence ``(T, B, Cx, H, W)`` (or ``(B, Cx, H, W)`` with
    ``x_static=True``, every step receiving the same tensor), initial hidden
    state ``(B, Ch, H, W)``; returns the stacked states ``(T, B, Ch, H, W)``.
    """

    def __init__(
        self, input_channels: int, output_channels: int, kernel_size: int = 3, sn_eps: float = 1e-4
    ):
        super().__init__()
        if kernel_size != 3:
            raise ValueError("ConvGRU's rollout takes 3x3 gate convs only")
        self.input_channels = input_channels
        self.output_channels = output_channels
        self.cell = ConvGRUCell(input_channels, output_channels, kernel_size, sn_eps)

    def forward(
        self,
        x_seq: torch.Tensor,
        hidden_state: torch.Tensor,
        n_steps: Optional[int] = None,
        x_static: bool = False,
    ) -> torch.Tensor:
        cell = self.cell
        xc = self.input_channels - self.output_channels
        # Spectral norm is applied by .weight (eval: constant across steps).
        convs = (cell.read_gate_conv, cell.update_gate_conv, cell.output_conv)
        kr, ku, kc = (conv.weight for conv in convs)
        bias = torch.cat([conv.bias for conv in convs])

        # Input parts of all three gates as one conv, batched over every step.
        k_x = torch.cat([kr[:, :xc], ku[:, :xc], kc[:, :xc]])
        if x_static:
            if n_steps is None:
                raise ValueError("x_static requires n_steps")
            gx = F.conv2d(x_seq, k_x, padding=1)[None]
        else:
            t, b = x_seq.shape[:2]
            gx = F.conv2d(x_seq.flatten(0, 1), k_x, padding=1).unflatten(0, (t, b))

        # The rollout takes the JAX layouts: NHWC activations, HWIO kernels.
        to_hwio = lambda w: w.permute(2, 3, 1, 0).contiguous()  # noqa: E731
        out = convgru_rollout(
            gx.permute(0, 1, 3, 4, 2).contiguous(),
            hidden_state.permute(0, 2, 3, 1).contiguous(),
            to_hwio(torch.cat([kr[:, xc:], ku[:, xc:]])),
            to_hwio(kc[:, xc:]),
            bias.contiguous(),
            n_steps=n_steps,
        )
        return out.permute(0, 1, 4, 2, 3)  # (T, B, C, H, W)
