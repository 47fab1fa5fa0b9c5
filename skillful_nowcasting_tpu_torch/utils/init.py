"""Seeded random weights (port of ``skillful_nowcasting_tpu/utils/init.py:random_fill_variables``).

Fills a model so a full-width forward has finite O(1) activations without
downloaded weights:

* conv kernels He-scaled, ``N(0, 2 / fan_in)``; biases 0;
* BatchNorm scale 1 / bias 0, running mean 0 / var 1;
* attention ``gamma`` 0 (reference init);
* spectral-norm ``(u, v)``: 15 power iterations on the filled kernel, so
  ``sigma`` is a genuine top singular value (random vectors give a near-zero
  sigma and exploding activations).
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn.utils import parametrize

from ..layers.attention import AttentionLayer
from ..ops.spectral_norm import init_uv, kernel_to_weight_mat


@torch.no_grad()
def random_fill(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill ``model`` in place from ``generator`` (a CPU ``torch.Generator``) and return it."""
    for mod in model.modules():
        if isinstance(mod, nn.BatchNorm2d):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.reset_running_stats()
        elif isinstance(mod, nn.Conv2d):
            sn = parametrize.is_parametrized(mod, "weight")
            w = mod.parametrizations.weight.original if sn else mod.weight
            fan_in = w[0].numel()
            w.copy_(torch.randn(w.shape, generator=generator) * math.sqrt(2.0 / fan_in))
            if mod.bias is not None:
                mod.bias.zero_()
            if sn:
                norm = mod.parametrizations.weight[0]
                u, v = init_uv(kernel_to_weight_mat(w.cpu()), norm.eps, generator)
                norm._u.copy_(u)
                norm._v.copy_(v)
        elif isinstance(mod, AttentionLayer):
            mod.gamma.zero_()
    return model
