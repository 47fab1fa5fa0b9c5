"""Conv2d / Conv3d / Linear with optional spectral norm, in the reference's module schema.

Port of ``skillful_nowcasting_tpu/ops/conv.py`` (``Conv`` 2-D and 3-D,
``Dense``). The JAX layers store HWIO / DHWIO / ``(in, out)`` kernels and
apply SN themselves; here plain ``nn.Conv2d`` / ``nn.Conv3d`` / ``nn.Linear``
(OIHW, OIDHW, ``(out, in)``) carry the
:class:`~.spectral_norm.SpectralNorm` parametrization, so their state dicts
have the reference torch keys.

Every layer's ``forward(x, steps=None)`` takes the JAX ``sequential`` train
semantics: in train mode a spectrally normalized layer runs one power
iteration per forward, and with ``steps=S`` the batch holds ``S`` slices
(slice-major, ``N = S * B``) that stand for ``S`` sequential forwards, slice
``t`` seeing its own ``sigma_t``. Since the layer is linear, ONE batched
conv (or matmul) with the raw weight runs over all slices and slice ``t``
is divided by ``sigma_t`` before the bias is added
(``skillful_nowcasting_tpu/ops/conv.py:121-171,205-237``). In eval mode and
without spectral norm, ``steps`` changes nothing.

Compute follows the input's dtype, as in JAX (``dtype = self.dtype or
x.dtype``): the weight (spectral norm applied in the parameter's dtype) and
the bias are cast to ``x.dtype`` at use, so one f32 model serves and trains
on f32 and bf16 inputs. In a train forward the power iterations and sigmas
stay in the parameter's dtype; the sigmas are cast at the division.

With ``space=`` (a :class:`~..parallel.spatial.SpaceLayout`) the input is
this rank's stripe of an H-sharded field, in eval and in train mode: a SAME
stride-1 2-D conv exchanges its halo rows (``space.conv``), a 3-D one on
NCDHW its rows in H, a 1x1 conv runs on the stripe as it is. The power
iterations read the weight only, so every rank runs them alike and they
advance once per forward, as without a layout.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import parametrize

from .spectral_norm import spectral_norm as _spectral_norm


class _TrainSpectral:
    """``forward(x, steps=None, space=None)`` shared by the three layers below."""

    def _linear(self, x: torch.Tensor, weight: torch.Tensor, bias=None, space=None):
        """The layer on an explicit weight and bias (convs; :class:`Linear` overrides)."""
        if space is None:
            return self._conv_forward(x, weight, bias)
        k, pad = self.kernel_size[0], (self.kernel_size[0] - 1) // 2
        if (self.kernel_size == (k,) * len(self.kernel_size) and k % 2
                and self.padding == (pad,) * len(self.kernel_size)
                and set(self.stride) == set(self.dilation) == {1} and self.groups == 1):
            return space.conv(x, weight, bias, padding=pad)  # 1x1: no rows exchanged
        raise ValueError(f"{type(self).__name__} {tuple(weight.shape)} with padding "
                         f"{self.padding} has no H-sharded version: a sharded forward takes "
                         "stride-1 SAME convs")

    def forward(self, x: torch.Tensor, steps: Optional[int] = None, space=None) -> torch.Tensor:
        if not (self.training and parametrize.is_parametrized(self, "weight")):
            bias = None if self.bias is None else self.bias.to(x.dtype)
            return self._linear(x, self.weight.to(x.dtype), bias, space)
        raw = self.parametrizations.weight.original
        sigmas = self.parametrizations.weight[0].advance(raw, steps or 1)
        y = self._linear(x, raw.to(x.dtype), space=space)
        y = y.unflatten(0, (sigmas.shape[0], -1))
        y = y / sigmas.to(y.dtype).view((-1,) + (1,) * (y.ndim - 1))
        y = y.flatten(0, 1)
        if self.bias is None:
            return y
        return y + self.bias.to(y.dtype).view((-1,) + (1,) * (y.ndim - 2))


class Conv2d(_TrainSpectral, nn.Conv2d):
    """``nn.Conv2d`` whose train forward applies per-slice spectral norm."""


class Conv3d(_TrainSpectral, nn.Conv3d):
    """``nn.Conv3d`` whose train forward applies per-slice spectral norm."""


class Linear(_TrainSpectral, nn.Linear):
    """``nn.Linear`` (weight ``(out, in)``) whose train forward applies per-slice spectral norm."""

    def _linear(self, x, weight, bias=None, space=None):
        if space is not None:
            raise ValueError("a Linear layer has no H-sharded version")
        return F.linear(x, weight, bias)


def conv2d(
    in_channels: int,
    out_channels: int,
    kernel_size: int = 3,
    padding: int = 0,
    bias: bool = True,
    spectral_norm: bool = False,
    sn_eps: float = 1e-12,
) -> Conv2d:
    """A stride-1 :class:`Conv2d`, spectrally normalized when ``spectral_norm``."""
    conv = Conv2d(in_channels, out_channels, kernel_size, padding=padding, bias=bias)
    return _spectral_norm(conv, sn_eps) if spectral_norm else conv


def conv3d(
    in_channels: int,
    out_channels: int,
    kernel_size: int = 3,
    padding: int = 0,
    bias: bool = True,
    spectral_norm: bool = False,
    sn_eps: float = 1e-12,
) -> Conv3d:
    """A stride-1 :class:`Conv3d` on NCDHW, spectrally normalized when ``spectral_norm``."""
    conv = Conv3d(in_channels, out_channels, kernel_size, padding=padding, bias=bias)
    return _spectral_norm(conv, sn_eps) if spectral_norm else conv


def dense(
    in_features: int,
    out_features: int,
    bias: bool = True,
    spectral_norm: bool = False,
    sn_eps: float = 1e-12,
) -> Linear:
    """The JAX ``Dense``: a :class:`Linear`, spectrally normalized when ``spectral_norm``."""
    layer = Linear(in_features, out_features, bias=bias)
    return _spectral_norm(layer, sn_eps) if spectral_norm else layer
