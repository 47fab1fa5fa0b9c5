"""BatchNorm with torch semantics: port of ``skillful_nowcasting_tpu/ops/norm.py:TorchBatchNorm``.

Eval normalizes with the running statistics as ``nn.BatchNorm2d`` /
``nn.BatchNorm1d`` do (keys ``weight``, ``bias``, ``running_mean``,
``running_var``, ``num_batches_tracked``): the scale and shift are computed
in the statistics' dtype and cast to the input's, so compute follows the
input's dtype as in JAX (``ops/norm.py:60-67``) and one f32 model serves f32
and bf16 inputs. Train mode follows the JAX module
(``ops/norm.py:60-119``):

* statistics at no less than f32, ``var = E[x^2] - mean^2``;
* the biased variance normalizes, the unbiased one (``n / (n - 1)``) feeds
  the running variance;
* ``forward(x, steps=S)`` treats the batch as ``S`` slices (slice-major,
  ``N = S * B``), each normalized with its own statistics, and gives the
  running statistics the closed form of ``S`` sequential updates:
  ``r' = (1-m)^S r + m * sum_t (1-m)^(S-1-t) stat_t``.

``num_batches_tracked`` (JAX has no such counter) rises by ``S``, the
number of torch train forwards the call stands for; nothing reads it, since
the momentum is fixed.

Inside :func:`sync_batch_norm` a layer's train forward is synchronised over a
process group, as a single-device step on the global batch would compute it
(the data-parallel ``pjit`` mode): each slice's sums of ``x`` and ``x^2``
and the element count are summed over the ranks by an autograd-aware
all-reduce (:func:`sum_over_ranks`) before the mean and variance, so the
backward pass all-reduces their gradients in turn. The unbiased
factor uses the global count. Every rank must run the same forwards in the
same order (and so the same backward and recompute), as the train step does.
The H-sharded step gives each layer its own group: the generator's
BatchNorms see stripes of every rank's rows (the whole mesh), the
discriminator heads' values that every rank of a space group holds alike
(the data group), so :func:`sync_batch_norm` blocks nest.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn


@contextlib.contextmanager
def sync_batch_norm(model: nn.Module, group):
    """Synchronise the train-mode forwards of ``model``'s BatchNorms over ``group`` in the block.

    ``group=None`` synchronises nothing. Each layer keeps the group in its
    ``sync_group`` attribute while the block runs and gets its former group
    back after, so an inner block can give a submodule another group.
    """
    layers = [m for m in model.modules() if isinstance(m, _TorchBatchNorm)]
    before = [m.sync_group for m in layers]
    for m in layers:
        m.sync_group = group
    try:
        yield
    finally:
        for m, g in zip(layers, before):
            m.sync_group = g


class _SumOverRanks(torch.autograd.Function):
    """An all-reduce (sum) whose gradient is the all-reduce of the ranks' gradients.

    Its backward is itself a ``_SumOverRanks``, so a double backward (R1)
    differentiates through it too. (``torch.distributed.nn.functional.all_reduce``
    computes the same, and is deprecated.)
    """

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        import torch.distributed as dist

        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _SumOverRanks.apply(grad, ctx.group), None


def sum_over_ranks(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``'s ranks, differentiable to any order (the backward all-reduces)."""
    return _SumOverRanks.apply(x, group)


def _moments(xs: torch.Tensor, red, s: int, group):
    """Per-slice mean and biased variance ``(S, C)``, and the unbiased factor ``n / (n - 1)``."""
    n = xs[:, :, 0].numel() // s  # elements of one slice and channel
    if group is None:
        mean = xs.mean(dim=red)
        return mean, (xs * xs).mean(dim=red) - mean * mean, n / max(n - 1, 1)
    sums = torch.cat([xs.sum(dim=red).reshape(-1), (xs * xs).sum(dim=red).reshape(-1),
                      xs.new_full((1,), float(n))])
    sums = sum_over_ranks(sums, group)
    n = sums[-1].detach()  # the global count, kept on the device
    mean, sq = sums[:-1].view(2, s, -1) / n
    return mean, sq - mean * mean, n / (n - 1).clamp_min(1)


class _TorchBatchNorm:
    """``forward(x, steps=None)`` shared by the 1-D and 2-D layers below."""

    sync_group = None  # a process group inside sync_batch_norm

    def forward(self, x: torch.Tensor, steps: Optional[int] = None) -> torch.Tensor:
        if not self.training:
            scale = self.weight / torch.sqrt(self.running_var + self.eps)
            shift = self.bias - self.running_mean * scale
            shape = (-1,) + (1,) * (x.ndim - 2)
            return x * scale.to(x.dtype).view(shape) + shift.to(x.dtype).view(shape)
        s = steps or 1
        xs = x.unflatten(0, (s, -1)).to(torch.promote_types(x.dtype, torch.float32))
        red = (1,) + tuple(range(3, xs.ndim))  # all but the slice and channel axes
        mean, var, unbiased_factor = _moments(xs, red, s, self.sync_group)  # (S, C), biased
        with torch.no_grad():
            m = self.momentum
            decay = (1.0 - m) ** torch.arange(s - 1, -1, -1, dtype=mean.dtype, device=x.device)
            unbiased = var * unbiased_factor
            for running, stat in ((self.running_mean, mean), (self.running_var, unbiased)):
                running.copy_((1.0 - m) ** s * running + m * (decay @ stat))
            self.num_batches_tracked.add_(s)
        shape = (s, -1) + (1,) * (xs.ndim - 3)
        inv = 1.0 / torch.sqrt(var + self.eps) * self.weight
        y = (xs - mean.view(shape).unsqueeze(1)) * inv.view(shape).unsqueeze(1)
        y = y + self.bias.view((-1,) + (1,) * (xs.ndim - 3))
        return y.flatten(0, 1).to(x.dtype)


class BatchNorm2d(_TorchBatchNorm, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` on ``(N, C, H, W)`` with the JAX train semantics."""


class BatchNorm1d(_TorchBatchNorm, nn.BatchNorm1d):
    """``nn.BatchNorm1d`` on ``(N, C)`` with the JAX train semantics (the discriminator heads)."""
