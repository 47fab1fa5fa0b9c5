"""Spectral normalization with PyTorch's parametrization key schema.

Port of ``skillful_nowcasting_tpu/ops/spectral_norm.py``. The weight matrix is
torch's ``(out, fan_in)`` view, which an OIHW / OIDHW / ``(out, in)`` weight
gives by a plain reshape; ``sigma = u . (W v)``; a fresh ``(u, v)`` is a pair
of normalized gaussians after 15 power iterations.

:class:`SpectralNorm` is a parametrization for
``torch.nn.utils.parametrize.register_parametrization``: registered on a
layer's ``weight`` it stores ``parametrizations.weight.original`` and the
``parametrizations.weight.0._u`` / ``._v`` buffers, the reference state-dict
keys. Reading ``.weight`` always gives ``W / sigma`` with the stored vectors
and never advances them (the JAX ``update_stats=False`` read). Train mode's
power iterations run in the owning layer's forward, through
:meth:`SpectralNorm.advance`: torch's parametrization evaluates ``weight``
once per access, so it cannot hand a sequence of per-slice sigmas to one
batched conv.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn.utils import parametrize


def _l2_normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    """torch.nn.functional.normalize: x / max(||x||_2, eps)."""
    return x / torch.clamp(torch.linalg.vector_norm(x), min=eps)


def kernel_to_weight_mat(weight: torch.Tensor) -> torch.Tensor:
    """OIHW / OIDHW conv (or ``(out, in)`` linear) weight -> torch's ``(out, fan_in)`` matrix."""
    return weight.reshape(weight.shape[0], -1)


def power_iteration(
    weight_mat: torch.Tensor,
    u: torch.Tensor,
    v: torch.Tensor,
    eps: float,
    n_iterations: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Torch-ordered power iterations: u first, then v."""
    for _ in range(n_iterations):
        u = _l2_normalize(weight_mat @ v, eps)
        v = _l2_normalize(weight_mat.T @ u, eps)
    return u, v


def spectral_sigma(weight_mat: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """sigma = u . (W v), torch's estimate of the top singular value."""
    return torch.dot(u, weight_mat @ v)


def init_uv(
    weight_mat: torch.Tensor, eps: float, generator: Optional[torch.Generator] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fresh (u, v): normalized gaussians + 15 power iterations (torch init)."""
    h, w = weight_mat.shape
    u = _l2_normalize(torch.randn(h, generator=generator, dtype=weight_mat.dtype), eps)
    v = _l2_normalize(torch.randn(w, generator=generator, dtype=weight_mat.dtype), eps)
    return power_iteration(weight_mat, u.to(weight_mat.device), v.to(weight_mat.device), eps, 15)


class SpectralNorm(nn.Module):
    """Spectral-norm parametrization: ``weight / (u . (W v))`` with the stored ``(u, v)``."""

    def __init__(self, weight: torch.Tensor, eps: float = 1e-12):
        super().__init__()
        self.eps = eps
        with torch.no_grad():
            u, v = init_uv(kernel_to_weight_mat(weight), eps)
        self.register_buffer("_u", u)
        self.register_buffer("_v", v)

    def forward(self, weight: torch.Tensor) -> torch.Tensor:
        return weight / spectral_sigma(kernel_to_weight_mat(weight), self._u, self._v)

    def advance(self, weight: torch.Tensor, steps: int = 1) -> torch.Tensor:
        """Train mode: ``steps`` sequential forwards' sigmas, shape ``(steps,)``.

        Each forward runs one power iteration on the detached weight (torch's
        ``no_grad`` update of ``u``, ``v``) and estimates ``sigma_t = u_t .
        (W v_t)`` with the gradient flowing through ``W`` only. The buffers
        end at the last iteration's vectors.
        """
        wm = kernel_to_weight_mat(weight)
        us, vs = [], []
        with torch.no_grad():
            u, v = self._u, self._v
            for _ in range(steps):
                u, v = power_iteration(wm, u, v, self.eps)
                us.append(u)
                vs.append(v)
            self._u.copy_(u)
            self._v.copy_(v)
        return (torch.stack(us) * (torch.stack(vs) @ wm.T)).sum(dim=1)


def spectral_norm(module: nn.Module, eps: float = 1e-12) -> nn.Module:
    """Register :class:`SpectralNorm` on ``module.weight`` and return the module."""
    # unsafe=True: skip the consistency check's trial forward.
    parametrize.register_parametrization(
        module, "weight", SpectralNorm(module.weight, eps), unsafe=True
    )
    return module
