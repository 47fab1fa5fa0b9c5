"""Conv2d with optional spectral norm, in the reference's module schema.

Port of the eval path of ``skillful_nowcasting_tpu/ops/conv.py:Conv`` (2-D).
The JAX ``Conv`` stores an HWIO kernel and applies SN itself; here a plain
``nn.Conv2d`` (OIHW) carries the :class:`~.spectral_norm.SpectralNorm`
parametrization, so its state dict has the reference torch keys. ``Dense``
and the train-mode per-timestep sigma sequence are not ported yet.
"""

from __future__ import annotations

from torch import nn

from .spectral_norm import spectral_norm as _spectral_norm


def conv2d(
    in_channels: int,
    out_channels: int,
    kernel_size: int = 3,
    padding: int = 0,
    bias: bool = True,
    spectral_norm: bool = False,
    sn_eps: float = 1e-12,
) -> nn.Conv2d:
    """A stride-1 ``nn.Conv2d``, spectrally normalized when ``spectral_norm``."""
    conv = nn.Conv2d(in_channels, out_channels, kernel_size, padding=padding, bias=bias)
    return _spectral_norm(conv, sn_eps) if spectral_norm else conv
