"""Shared helpers of the PyTorch-port parity tests (``test_torch_*.py``).

Weights come from the JAX package: an abstract variable tree is filled with
``random_fill_variables`` (no init compile), then BN statistics, biases and
the attention ``gamma`` are perturbed so the BN fold, the bias paths and
quirk Q1 are exercised (``gamma`` starts at 0). The tree is carried into the
port by ``state_dict_from_variables`` and ``load_state_dict(strict=True)``.
Arrays cross between the frameworks as numpy copies.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from skillful_nowcasting_tpu.utils import random_fill_variables
from skillful_nowcasting_tpu_torch.hub import state_dict_from_variables

# Per-block tolerances of the JAX parity suite (tests/test_blocks_parity.py).
RTOL = 2e-4
ATOL = 2e-5


def perturb(tree, seed: int):
    """Non-trivial BN stats, biases and attention gamma (numpy tree)."""
    rng = np.random.default_rng(seed)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, tuple):  # spectral (u, v): consistent with the kernels
            return tuple(np.array(a) for a in node)
        a = np.array(node)
        if name == "gamma":
            return np.full_like(a, 0.5)
        if name in ("bias", "scale", "mean"):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if name == "var":
            return (a * np.exp(0.2 * rng.standard_normal(a.shape))).astype(a.dtype)
        return a

    return walk(tree)


def jax_variables(module, *args, seed: int = 0, **kwargs):
    """Filled + perturbed numpy variable tree for a Flax module called on ``args``."""
    abstract = jax.eval_shape(lambda: module.init(jax.random.key(0), *args, **kwargs))
    filled = jax.tree.map(np.array, random_fill_variables(abstract, seed))
    return perturb(filled, seed + 1)


def load_port(module: torch.nn.Module, variables) -> torch.nn.Module:
    """Strictly load a JAX variable tree into a port module and set eval mode."""
    module.load_state_dict(state_dict_from_variables(variables), strict=True)
    return module.eval()


def t(a) -> torch.Tensor:
    """numpy / JAX array -> torch tensor (copied, never aliased)."""
    return torch.from_numpy(np.array(a))


def nhwc_to_nchw(a) -> torch.Tensor:
    return t(np.moveaxis(np.array(a), -1, -3))


def nchw_to_nhwc(x: torch.Tensor) -> np.ndarray:
    return np.moveaxis(np.array(x.detach()), -3, -1)


def randn(rng, *shape, scale: float = 1.0) -> np.ndarray:
    return (rng.standard_normal(shape) * scale).astype(np.float32)

