"""CoordConv: a conv over its input with normalized coordinate channels appended, NCHW.

Port of ``skillful_nowcasting_tpu/layers/coord_conv.py``. The appended
channels are, in order, the row coordinate (varying along H) and the column
coordinate (varying along W), each spanning [-1, 1], and optionally the
radial channel ``sqrt((row - 0.5)^2 + (col - 0.5)^2)``: the reference takes
the radius from the [-1, 1]-scaled coordinates minus 0.5, reproduced exactly.

The blocks do not take ``conv_type="coord"`` (see
:func:`~.utils.refuse_coord`); the layer itself and the
``get_conv_layer("coord")`` factory are what the JAX package offers.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import conv2d


def _coords(n: int, device) -> torch.Tensor:
    """``jnp.linspace(-1, 1, n)`` in float32 as XLA computes it; zeros for ``n == 1``.

    XLA multiplies by the float32 reciprocal of ``n - 1`` and contracts
    ``-(1 - s) + s`` into fused multiply-adds: ``s = i * r`` stays unrounded,
    ``1 - s`` is rounded once, and ``s - round(1 - s)`` once. Float64 holds
    each of those intermediates exactly, so it stands in for the FMA. On
    n = 2..1199 this gives XLA:CPU's bits at 95 sizes and is at most half a
    float32 ulp at 1 (5.96e-8) off elsewhere, against 11 sizes and 1.79e-7
    for ``torch.linspace``.
    """
    if n == 1:
        return torch.zeros(1, device=device)
    r = torch.reciprocal(torch.tensor(float(n - 1), dtype=torch.float32)).item()
    s = torch.arange(n - 1, dtype=torch.float64, device=device) * r
    head = (s - (1.0 - s).float().double()).float()
    return torch.cat([head, torch.ones(1, device=device)])


def add_coords(x: torch.Tensor, with_r: bool = False) -> torch.Tensor:
    """Append the row and column coordinates (and ``r`` if ``with_r``) to NCHW ``x`` at dim 1.

    Each channel is cast to ``x.dtype`` before ``r`` is computed from them, as in JAX.
    """
    b, _, h, w = x.shape
    row = _coords(h, x.device).to(x.dtype).view(1, 1, h, 1).expand(b, 1, h, w)
    col = _coords(w, x.device).to(x.dtype).view(1, 1, 1, w).expand(b, 1, h, w)
    parts = [x, row, col]
    if with_r:
        parts.append(torch.sqrt((row - 0.5).square() + (col - 0.5).square()))
    return torch.cat(parts, dim=1)


class CoordConv(nn.Module):
    """:func:`add_coords`, then a :func:`~skillful_nowcasting_tpu_torch.ops.conv2d` named ``conv``.

    ``conv2d_kwargs`` are ``conv2d``'s (``kernel_size``, ``padding``,
    ``bias``, ``spectral_norm``, ``sn_eps``); the inner conv takes 2 (or 3
    with ``with_r``) more input channels. Its state-dict keys are ``conv.*``,
    those of the JAX layer's ``conv`` submodule. In train mode a spectrally
    normalized inner conv advances its ``u`` / ``v`` once per forward.
    """

    def __init__(self, in_channels: int, out_channels: int, with_r: bool = False,
                 **conv2d_kwargs):
        super().__init__()
        self.with_r = with_r
        self.conv = conv2d(in_channels + 2 + int(with_r), out_channels, **conv2d_kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(add_coords(x, self.with_r))


def coord_conv2d(
    in_channels: int,
    out_channels: int,
    kernel_size: int = 3,
    padding: int = 0,
    bias: bool = True,
    spectral_norm: bool = False,
    sn_eps: float = 1e-12,
) -> CoordConv:
    """A :class:`CoordConv` (``with_r=False``) with :func:`~skillful_nowcasting_tpu_torch.ops.conv2d`'s signature."""
    return CoordConv(in_channels, out_channels, kernel_size=kernel_size, padding=padding,
                     bias=bias, spectral_norm=spectral_norm, sn_eps=sn_eps)
